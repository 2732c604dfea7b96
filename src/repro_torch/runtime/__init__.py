"""Multi-GPU runtime of the port (port of `repro.runtime`, on
`torch.distributed`): the sharding rules, elastic mesh choice, straggler
detection and the GPipe pipeline."""
