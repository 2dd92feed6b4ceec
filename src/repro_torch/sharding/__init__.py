"""Partition rules (`rules`) and the active mesh's sharding context
(`ctx`) of tensor-parallel serving."""
