"""safe_retry_share: the share of the window's chunks that the program
decoded a second time at its safe symbol-step count, in %.

A restart chunk whose entropy-coded bytes hold a stretch denser than the
fast scan's steps per byte takes (BatchStats.fsm_k_retries) a second
device decode at STEPS_SAFE, with its own memory and time.  Counter: Σ
fsm_k_retries / Σ chunks over the window's calls.  Nothing to read where
the window decoded no chunk."""


def read(ctx):
    chunks = sum(s["chunks"] for s in ctx.window.stats)
    if chunks == 0:
        return None
    return 100.0 * sum(s["fsm_k_retries"] for s in ctx.window.stats) / chunks
