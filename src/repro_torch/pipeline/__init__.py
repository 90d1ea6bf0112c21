"""The device-side block pipeline on one device (port of repro.pipeline):
the validation stages (:mod:`.stages`), the window's batched fill and write
planner (:mod:`.batched_mvcc`), the fill/steady/drain schedule
(:mod:`.schedule`) and the engine's window committer
(:mod:`.engine_bridge`)."""
