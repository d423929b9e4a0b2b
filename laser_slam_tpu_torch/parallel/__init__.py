"""Fleet batching: many independent trajectories on one card."""
