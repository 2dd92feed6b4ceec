"""Partition rules (`rules`), the active mesh's sharding context (`ctx`),
the int8-compressed gradient all-reduce (`compress`) and the GPipe
schedule over a "stage" axis (`pipeline`)."""
