"""Repository analysers of the port. :mod:`convergence_gate` runs a small
fixed-seed convergence grid through the port and diffs each entry against
its blessed envelope (``convergence.json``), so a change that degrades
model quality fails like a broken test."""
