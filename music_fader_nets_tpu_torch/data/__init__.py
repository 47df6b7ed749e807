"""Corpora, dataset views and batch iteration (own copies of the JAX
package's `data/` modules, which import no JAX)."""
