"""Multi-device training for the port: the device mesh and its sharding rules,
the ZeRO-3 gather, tensor parallelism's collectives, the GPipe pipeline, ring
context parallelism, and a launcher for ranks on one host."""
