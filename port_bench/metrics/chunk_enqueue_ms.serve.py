"""chunk_enqueue_ms.serve: the mean host time of one call of the engine's
prefill functions (`runtime/engine.py:make_prefill_chunk_step` for each
chunk of a prompt longer than a chunk, `make_prefill_unrolled` for a
shorter prompt), from the harness's timer around each call, over the
calls made in the untraced part of a traced run's window (the profiler
adds its own cost to every host op it records): what the host spends
launching one chunk's work."""


def read(ctx):
    chunks = ctx.get("chunks")
    if not chunks:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, *_ in chunks) / len(chunks)
