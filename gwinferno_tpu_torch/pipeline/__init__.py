"""Data loading, the hierarchical likelihood and the bench model."""
