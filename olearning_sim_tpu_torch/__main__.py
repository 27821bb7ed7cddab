"""``python -m olearning_sim_tpu_torch --config platform.ini`` — stand up
the platform (the reference's per-service ``test/*/..._srv.py`` entry
points + ``config/config.conf`` wiring, as one command).

The JAX package's ``__main__.py`` for the port: the session serves no gRPC
port (tasks enter through the intake queue the config names), so
``--print-port`` is refused, and ``--device`` (``cuda``, the default, or
``cpu``) takes the place of the JAX package's ``--platform``. SIGINT or
SIGTERM stops the session and exits 0."""

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
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the platform runs (cuda fails without a card)",
    )
    ap.add_argument("--print-port", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.print_port:
        ap.error("--print-port: the PyTorch port serves no gRPC port; push "
                 "task JSON onto the intake queue (repos.intake_queue_path)")

    from olearning_sim_tpu_torch.config import session_from_file

    session = session_from_file(args.config, device=args.device)
    stop = threading.Event()

    def _sig(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    session.start()
    print(
        f"olearning_sim_tpu_torch platform running on {session.device} "
        f"(services: {', '.join(session.services)})",
        file=sys.stderr, flush=True,
    )
    stop.wait()
    session.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
