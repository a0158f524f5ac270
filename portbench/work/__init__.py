"""The work of a stage, counted from the inputs, the configuration and the
plain reference's counts (never from what a kernel does): each
``work(run, counts) -> (f32 operations, bytes)``."""
