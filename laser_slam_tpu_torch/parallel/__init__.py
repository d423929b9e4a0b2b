"""Fleet batching (``fleet``: many independent trajectories on one card)
and sharding over a mesh of devices (``sharding``: the fleet step split
over lanes and points, the pose-graph solve over factors)."""
