"""Episode drills of the port: the deterministic track follower and batched
open- and closed-loop episode runners (``episodes``)."""
