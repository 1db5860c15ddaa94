"""mfu.serve: the prefill's share of the card's bf16 peak.

For each prefill call the engine made in the untraced part of a traced
run's window: the least time its prompt rows need at 989 TFLOP/s
(pbench/roofline.py:prefill_seconds_at_peak: the products and
attention's visible pairs of every layer, the head only at a prompt's
last position); summed, over that part's seconds. Padding rows and the
head's logits at other positions are work the requests do not need and
are not counted."""

from pbench import roofline


def read(ctx):
    chunks, seconds = ctx.get("chunks"), ctx.get("untraced_s")
    if not chunks or not seconds:
        return None
    t = sum(roofline.prefill_seconds_at_peak(ctx["config"], off, rows, last)
            for _, _, off, _, rows, last in chunks if rows > 0)
    return 100.0 * t / seconds
