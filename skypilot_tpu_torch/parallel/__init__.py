"""Training across ranks: the mesh and sharding rules, parameter placement
and the collectives of the sharded step, ring attention, the GPipe
pipeline."""
