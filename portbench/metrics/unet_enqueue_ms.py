"""unet_enqueue_ms: the median over the window's calls of the host time inside the call spent in
the program's ``diffsim.unet`` spans: the UNet's launches, from its embeddings to the tap."""

from portbench.harness.spans import per_call_ms


def read(r):
    return per_call_ms(r.trace, lambda n: n == "diffsim.unet")
