"""Dataset views and batch iteration (own copies of the JAX package's
`data/datasets.py` and `data/loader.py`, which import no JAX)."""
