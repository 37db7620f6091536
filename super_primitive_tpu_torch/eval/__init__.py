"""Trajectory evaluation and the synthetic end-to-end run."""
