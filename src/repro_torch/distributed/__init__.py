"""Placement plans: the reference's sharding rules as DTensor placements."""
