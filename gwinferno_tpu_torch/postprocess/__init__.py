"""Post-processing: the posterior-predictive distributions and plots of a run."""
