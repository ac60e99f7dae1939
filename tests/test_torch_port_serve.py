"""The port's scoring service on the CPU (``python -m diffsim_tpu_torch.cli.serve``), the
counterparts of ``tests/test_serve.py``: the HTTP surface over a real localhost socket, path and
base64 inputs, cross-request micro-batching (a round scores exactly the pairs it fused: no
padding), oversize requests chunked, a failed chunk cancelling its queued siblings; and a served
score equal to the scorer's own ``score_batch`` on the same pixels, whatever shares its round.
Tiny SD-1.5 at 32 px, ``device="cpu"``."""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from diffsim_tpu_torch.cli.args import arg_parse
from diffsim_tpu_torch.cli.serve import Batcher, _Work, make_server
from diffsim_tpu_torch.core.image import process_image_u8

FLAGS = ["--metric", "diffsim", "--model_scale", "tiny", "--image_size", "32",
         "--target_layer", "0", "--target_step", "600", "--similarity", "cosine",
         "--batch_size", "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    paths = []
    for i in range(4):
        p = str(root / f"im{i}.png")
        Image.fromarray(
            np.random.default_rng(i).integers(0, 256, (40, 40, 3)).astype(np.uint8)
        ).save(p)
        paths.append(p)
    srv, batcher = make_server(arg_parse(FLAGS), port=0, max_wait_ms=200.0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield {"port": srv.server_address[1], "paths": paths, "batcher": batcher}
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _post(port, payload, path="/score"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _counting(batcher, sizes):
    real = batcher._score

    def counting(pix_a, pix_b, prompts):
        sizes.append(len(prompts))
        return real(pix_a, pix_b, prompts)

    return real, counting


def test_serve_scores_paths_and_b64(server):
    port, paths = server["port"], server["paths"]
    out = _post(port, {"pairs": [[paths[0], paths[1]], [paths[2], paths[3]]],
                       "prompt": "The photo of a thing"})
    assert len(out["scores"]) == 2
    assert all(np.isfinite(out["scores"]))

    # the same image delivered as base64 bytes scores identically to its path
    b64 = base64.b64encode(open(paths[1], "rb").read()).decode()
    out2 = _post(port, {"pairs": [[paths[0], {"b64": b64}]],
                        "prompt": "The photo of a thing"})
    np.testing.assert_allclose(out2["scores"][0], out["scores"][0], atol=1e-5)

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert h["ok"] is True and h["metric"] == "diffsim" and h["pending"] == 0


def test_serve_fuses_concurrent_requests(server):
    """Two concurrent 1-pair requests inside the batcher's wait window score in ONE call of
    exactly two pairs, and each caller gets its own score back."""
    port, paths, batcher = server["port"], server["paths"], server["batcher"]
    calls = []
    real, batcher._score = _counting(batcher, calls)
    try:
        results = [None, None]

        def go(i, pair):
            results[i] = _post(port, {"pairs": [pair], "prompt": "x"})["scores"][0]

        threads = [threading.Thread(target=go, args=(0, [paths[0], paths[1]])),
                   threading.Thread(target=go, args=(1, [paths[2], paths[3]]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher._score = real
    assert all(r is not None and np.isfinite(r) for r in results)
    assert calls == [2], calls  # fused, and not padded to max_batch
    assert results[0] != results[1]


def test_serve_oversize_request_chunks(server):
    """A request larger than max_batch is split into max_batch chunks, one round each; the
    chunks keep each pair's identity."""
    port, paths, batcher = server["port"], server["paths"], server["batcher"]
    sizes = []
    real, batcher._score = _counting(batcher, sizes)
    try:
        n = batcher._max_batch + 3
        pairs = [[paths[i % 2], paths[2 + i % 2]] for i in range(n)]
        out = _post(port, {"pairs": pairs, "prompt": "x"})
    finally:
        batcher._score = real
    assert len(out["scores"]) == n and all(np.isfinite(out["scores"]))
    assert sizes == [batcher._max_batch, 3], sizes
    one = _post(port, {"pairs": [pairs[0]], "prompt": "x"})["scores"][0]
    np.testing.assert_allclose(out["scores"][0], one, atol=1e-5)


def test_served_scores_equal_score_batch(server):
    """A served round's scores equal the scorer's ``score_batch`` on the same pixels, pair by
    pair, alone or fused with another request."""
    port, paths, batcher = server["port"], server["paths"], server["batcher"]
    pairs = [[paths[0], paths[3]], [paths[1], paths[2]], [paths[3], paths[3]]]
    served = _post(port, {"pairs": pairs, "prompt": "a cat"})["scores"]
    pix = {p: process_image_u8(Image.open(p), 32) for p in paths}
    pa = np.concatenate([pix[a] for a, _ in pairs])
    pb = np.concatenate([pix[b] for _, b in pairs])
    direct = batcher._score(pa, pb, ["a cat"] * 3)
    alone = [batcher._score(pa[i:i + 1], pb[i:i + 1], ["a cat"])[0] for i in range(3)]
    np.testing.assert_allclose(served, direct, rtol=0, atol=1e-5)
    np.testing.assert_allclose(served, alone, rtol=0, atol=1e-5)


def test_serve_client_faults_are_400_and_the_server_keeps_serving(server, tmp_path):
    port, paths = server["port"], server["paths"]
    for payload in ({"pairs": [[paths[0], str(tmp_path / "missing.png")]]}, {"no_pairs": 1}):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, payload)
        assert err.value.code == 400 and "error" in json.loads(err.value.read())
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, {"pairs": []}, path="/nowhere")
    assert err.value.code == 404
    assert np.isfinite(_post(port, {"pairs": [[paths[0], paths[1]]]})["scores"][0])


def test_serve_failed_chunk_cancels_queued_siblings():
    """When an early chunk of an oversize request fails, the batcher cancels the still-queued
    sibling chunks instead of scoring them into discarded results, and stays healthy."""
    scored = []

    def score(pix_a, pix_b, prompts):
        scored.append(len(prompts))
        if len(scored) == 1:
            raise RuntimeError("boom")
        return np.zeros(len(prompts), np.float32)

    b = Batcher(score, max_batch=2, max_wait_ms=1.0)
    pix = np.zeros((6, 8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit(_Work(pix, pix, ["p"] * 6))  # 3 chunks of 2; chunk 1 fails
    deadline = time.time() + 5
    while b.pending and time.time() < deadline:
        time.sleep(0.01)
    assert b.pending == 0
    assert scored == [2], scored
    ok = b.submit(_Work(pix[:1], pix[:1], ["p"]))
    assert ok.scores == [0.0]


def test_serve_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server(arg_parse(FLAGS), port=0)
