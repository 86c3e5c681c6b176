"""Scale-out on torch.distributed: the ("pairs", "db") mesh, pod-wide kNN,
point-sharded BA and frame-window consensus (port of ``parallel/``)."""
