"""FSDP sharding rules of the parameter tree."""
