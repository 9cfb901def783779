"""Post-processing: plots of a run."""
