"""``python -m olearning_sim_tpu_torch --config platform.yaml`` — stand up
the platform (the reference's per-service ``test/*/..._srv.py`` entry
points + ``config/config.conf`` wiring, as one command).

The JAX package's ``__main__.py`` for the port: the session serves gRPC on
the config's ``session.address`` (``configs/platform.yaml`` says
``0.0.0.0:50051``), and ``--print-port`` prints the bound port on stdout
once it serves; a config whose address is ``none`` runs in process and
serves no port, so ``--print-port`` is refused there. ``--device``
(``cuda``, the default, or ``cpu``) takes the place of the JAX package's
``--platform``. Serving without grpcio or protobuf fails at boot with an
error naming both. SIGINT or SIGTERM stops the session and exits 0."""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="olearning_sim_tpu_torch",
        description="Boot the device-simulation platform from a config file.",
    )
    ap.add_argument("--config", required=True, help="platform INI or YAML file")
    ap.add_argument(
        "--print-port", action="store_true",
        help="print the bound gRPC port on stdout once serving",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the platform runs (cuda fails without a card)",
    )
    args = ap.parse_args(argv)

    from olearning_sim_tpu_torch.config import session_from_file

    session = session_from_file(args.config, device=args.device)
    if args.print_port and session.address is None:
        ap.error("--print-port: the config's session address is none (in process), "
                 "so the platform serves no port")
    stop = threading.Event()

    def _sig(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    try:
        session.start()
    except ImportError as e:  # serving without grpcio/protobuf
        print(f"olearning_sim_tpu_torch: {e}", file=sys.stderr, flush=True)
        return 1
    where = (f"serving on port {session.port}" if session.address is not None
             else "running in process (no port)")
    print(
        f"olearning_sim_tpu_torch platform {where} on {session.device} "
        f"(services: {', '.join(session.services)})",
        file=sys.stderr, flush=True,
    )
    if args.print_port:
        print(session.port, flush=True)
    stop.wait()
    session.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
