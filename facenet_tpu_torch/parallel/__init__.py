"""The port's (data, model) process grid on torch.distributed: the grid and
its collectives (`mesh`), sharded pair statistics (`sharded_eval`) and the
launcher that starts a grid's ranks in one call (`launch`)."""
