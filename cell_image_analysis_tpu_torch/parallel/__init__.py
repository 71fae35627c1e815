"""The mesh: data-parallel shards over a list of devices (`mesh`,
`sharding`) and the halo-tiled plate route (`tiling`)."""
