"""mfu_pct: the FLOPs of the work completed in the traced window (UNet rows to the tap, VAE
encodes, readouts; counted on the reference, ``harness/work.py``) over the window times the
H100's bf16 dense peak."""

from portbench.harness import peaks


def read(r):
    if r.trace is None or r.work is None:
        return None
    flops = sum(r.work.flops(d.rows, d.images, d.pairs) for d in r.window.done
                if d.scores is not None)
    return 100.0 * flops / (r.trace.window_s * peaks.PEAK_BF16) if flops else None
