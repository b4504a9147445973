"""Fault tolerance on the host, sharding rules and cross-rank reductions
over `torch.distributed` ranks (`launch.mesh`)."""
