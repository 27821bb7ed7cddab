"""Real-dataset ingestion (MNIST / CIFAR / FEMNIST / Sent140 / NPZ):
format parsers, federated partitioners, and FileRepo-backed fetching.

Copies of the JAX package's ``data/`` modules (numpy, csv and the standard
library); :func:`to_client_dataset` packs the port's host-numpy
``ClientDataset``, which the task bridge pads, shards and places."""

from olearning_sim_tpu_torch.data.formats import (
    detect_and_load,
    hash_tokenize,
    load_cifar_dir,
    load_leaf_json,
    load_mnist_dir,
    load_npz,
    load_sent140_csv,
    read_idx,
)
from olearning_sim_tpu_torch.data.ingest import (
    clear_cache,
    fetch_dataset_dir,
    load_arrays,
    load_population,
)
from olearning_sim_tpu_torch.data.partition import (
    dirichlet_assignments,
    iid_assignments,
    partition,
    to_client_dataset,
    writer_assignments,
)

__all__ = [
    "detect_and_load", "hash_tokenize", "load_cifar_dir", "load_leaf_json",
    "load_mnist_dir", "load_npz", "load_sent140_csv", "read_idx",
    "clear_cache", "fetch_dataset_dir", "load_arrays", "load_population",
    "dirichlet_assignments", "iid_assignments", "partition",
    "to_client_dataset", "writer_assignments",
]
