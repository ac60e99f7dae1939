"""Published U^2-Net checkpoints (``u2net.pth`` / ``u2netp.pth``, torch state dicts) -> the
``u2net`` tree of ``models/u2net.py``, with numpy alone.

The port's copy of ``diffsim_tpu/convert/u2net_import.py``. The names follow the published u2net
repository: each REBNCONV holds ``conv_s1`` / ``bn_s1``; the stages are stage1 .. stage6 and
stage5d .. stage1d; six side convolutions and ``outconv``.
"""

from __future__ import annotations

import numpy as np

_BN_LEAVES = ("conv_s1.weight", "conv_s1.bias", "bn_s1.weight", "bn_s1.bias",
              "bn_s1.running_mean", "bn_s1.running_var",
              "bn_s1.num_batches_tracked")  # the last is torch's bookkeeping, unused


def _conv(sd, name: str) -> dict:
    return {"w": np.asarray(sd[f"{name}.weight"]).transpose(2, 3, 1, 0),  # OIHW -> HWIO
            "b": np.asarray(sd[f"{name}.bias"])}


def _rebnconv(sd, used: set, base: str) -> dict:
    used.update(f"{base}.{leaf}" for leaf in _BN_LEAVES)
    return {
        "conv": _conv(sd, f"{base}.conv_s1"),
        "bn": {
            "scale": np.asarray(sd[f"{base}.bn_s1.weight"]),
            "bias": np.asarray(sd[f"{base}.bn_s1.bias"]),
            "mean": np.asarray(sd[f"{base}.bn_s1.running_mean"], np.float32),
            "var": np.asarray(sd[f"{base}.bn_s1.running_var"], np.float32),
        },
    }


def _rsu(sd, used: set, base: str, height: int) -> dict:
    if height == 0:  # RSU-4F
        names = ["rebnconv1", "rebnconv2", "rebnconv3", "rebnconv4",
                 "rebnconv3d", "rebnconv2d", "rebnconv1d"]
    else:
        names = ([f"rebnconv{i}" for i in range(1, height + 1)]
                 + [f"rebnconv{i}d" for i in range(height - 1, 0, -1)])
    p = {"rebnconvin": _rebnconv(sd, used, f"{base}.rebnconvin")}
    for n in names:
        p[n] = _rebnconv(sd, used, f"{base}.{n}")
    return p


def convert_u2net(sd: dict, cfg) -> dict:
    """``cfg``: a ``models.u2net.U2NetConfig`` (``u2netp()`` for the 4.7 MB lite checkpoint).
    A key of ``sd`` that no leaf consumes raises."""
    used: set[str] = set()
    p: dict = {}
    for i, (h, *_rest) in enumerate(cfg.encoder, start=1):
        p[f"stage{i}"] = _rsu(sd, used, f"stage{i}", h)
    for i, (h, *_rest) in zip(range(5, 0, -1), cfg.decoder):
        p[f"stage{i}d"] = _rsu(sd, used, f"stage{i}d", h)
    for name in [f"side{i}" for i in range(1, 7)] + ["outconv"]:
        p[name] = _conv(sd, name)
        used.update({f"{name}.weight", f"{name}.bias"})
    leftover = set(sd) - used
    if leftover:
        raise ValueError(f"unconsumed u2net keys: {sorted(leftover)[:10]}")
    return p
