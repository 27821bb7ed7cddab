"""The plain reference: data, availability, models and rounds in plain PyTorch and NumPy.

It imports neither jax nor either package of the repo."""
