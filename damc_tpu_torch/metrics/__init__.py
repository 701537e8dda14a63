"""Evaluation metrics of the port: Frechet distance statistics (FID)."""
