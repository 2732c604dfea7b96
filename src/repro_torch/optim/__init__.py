"""Optimizer substrate of the port (port of `repro.optim`): so far the
int8 gradient compression with error feedback and its data-parallel
all-reduce. AdamW and the schedules come with training (ROADMAP Queue 1
item 6b)."""
