"""Scoring service of the port: an HTTP daemon wrapping any ``--metric`` with cross-request
micro-batching (counterpart of ``diffsim_tpu/cli/serve.py``, with its routes and flags).

A resident process keeps the weights on the card and turns many small concurrent requests into
full scoring calls: decoded images come through the caching ``ImageLoader``, requests queue into
a batcher thread that fuses everything waiting (up to 2 x ``--batch_size`` pairs) into one
``score_pairs`` call a round, and the scores fan back out.

    python -m diffsim_tpu_torch.cli.serve --port 8712 --metric diffsim --weights sd15.npz \\
        --target_block up_blocks --target_layer 0 --target_step 600 --similarity cosine

    POST /score    {"pairs": [[a, b], ...], "prompt": "..."}    -> {"scores": [...]}
        each of a/b: an image file path visible to the server, or
        {"b64": "<base64-encoded image file>"}
    GET  /healthz  -> {"ok": true, "metric": "...", "pending": N}

Only the batcher thread touches the card. A round scores exactly the pairs it fused: eager
PyTorch has no compiled graph to keep to one batch shape, so the JAX batcher's padding to
``max_batch`` is dropped. A pair's score does not depend on what shares its round: each call
seeds one generator and shares every draw across the batch (``core/prng.py``). The server runs
on ``cuda`` unless ``make_server`` is given ``device``; without a CUDA device it raises.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time

import numpy as np

from diffsim_tpu_torch.cli.args import arg_parse
from diffsim_tpu_torch.core.image import ImageLoader, load_image, process_image


class _Work:
    __slots__ = ("pix_a", "pix_b", "prompts", "event", "scores", "error", "cancelled",
                 "siblings")

    def __init__(self, pix_a, pix_b, prompts):
        self.pix_a, self.pix_b, self.prompts = pix_a, pix_b, prompts
        self.event = threading.Event()
        self.scores = None
        self.error = None
        self.cancelled = False  # set when a sibling chunk of the same request failed
        self.siblings = ()  # chunks of the same oversize request (all fail together)


class Batcher:
    """Fuses queued requests into one ``score_pairs`` call per round, at most ``max_batch``
    pairs; an oversize request is split into ``max_batch`` chunks, and a failed chunk cancels
    its queued siblings."""

    def __init__(self, score_pairs, max_batch: int, max_wait_ms: float = 5.0):
        self._score = score_pairs
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1e3
        self._q: queue.Queue[_Work] = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def pending(self) -> int:
        return self._q.qsize()

    def submit(self, work: _Work) -> _Work:
        if len(work.prompts) > self._max_batch:
            # a request never makes a round larger than max_batch: the card's memory holds it
            chunks = [
                _Work(work.pix_a[i:i + self._max_batch], work.pix_b[i:i + self._max_batch],
                      work.prompts[i:i + self._max_batch])
                for i in range(0, len(work.prompts), self._max_batch)
            ]
            for c in chunks:
                c.siblings = chunks  # a failed chunk cancels the rest (batcher-side, racelessly)
                self._q.put(c)
            work.scores = []
            for c in chunks:
                self._wait(c)
                work.scores.extend(c.scores)
            return work
        self._q.put(work)
        self._wait(work)
        return work

    def _wait(self, work: _Work):
        """Block for a result, surfacing a dead batcher thread instead of hanging forever."""
        while not work.event.wait(timeout=1.0):
            if not self._thread.is_alive():
                raise RuntimeError("batcher thread died; the service must be restarted")
        if work.error is not None:
            raise work.error

    def _run(self):
        carry: _Work | None = None
        while True:
            first = carry if carry is not None else self._q.get()
            carry = None
            if first.cancelled:
                first.event.set()  # nobody waits on a cancelled chunk; just drop it
                continue
            batch = [first]
            n = len(first.prompts)
            deadline = time.monotonic() + self._max_wait
            # fuse whatever arrives within the wait window, strictly capped at max_batch —
            # an over-cap arrival carries to the next round
            while n < self._max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    w = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if w.cancelled:
                    w.event.set()
                    continue
                if n + len(w.prompts) > self._max_batch:
                    carry = w
                    break
                batch.append(w)
                n += len(w.prompts)
            try:
                pix_a = np.concatenate([w.pix_a for w in batch], axis=0)
                pix_b = np.concatenate([w.pix_b for w in batch], axis=0)
                prompts = [p for w in batch for p in w.prompts]
                scores = np.asarray(self._score(pix_a, pix_b, prompts), np.float32)
                off = 0
                for w in batch:
                    k = len(w.prompts)
                    w.scores = scores[off : off + k].tolist()
                    off += k
            except BaseException as e:  # propagate to every waiter
                err = e if isinstance(e, Exception) else RuntimeError(f"fatal batcher error: {e!r}")
                for w in batch:
                    w.error = err
                    # cancel the failed request's still-queued sibling chunks BEFORE the next
                    # q.get(): a failed chunk fails the whole oversize request, so scoring its
                    # siblings would only burn device rounds on discarded results
                    for s in w.siblings:
                        if s is not w and s.scores is None:
                            s.cancelled = True
                if not isinstance(e, Exception):
                    # fatal (KeyboardInterrupt/SystemExit/...): let the thread die — _wait's
                    # liveness check turns subsequent requests into errors, not hangs
                    raise
            finally:
                for w in batch:
                    w.event.set()


def make_server(args, port: int, max_wait_ms: float = 5.0, *, device=None):
    """Build (ThreadingHTTPServer on 127.0.0.1, Batcher) for the parsed flags ``args``; the
    scorer runs on ``device`` (None: the card). The server is not started: call
    ``.serve_forever()`` (the tests drive it from a thread)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from diffsim_tpu_torch.cli.main import check_one_device
    from diffsim_tpu_torch.metrics.registry import build_metric

    check_one_device(args)
    adapter = build_metric(args, device)
    loader = ImageLoader(args.image_size, preprocess=adapter.preprocess,
                         fast_decode=args.fast_decode)
    prep = adapter.preprocess or (lambda img: process_image(img, args.image_size))
    batcher = Batcher(adapter.score_pairs, max_batch=args.batch_size * 2,
                      max_wait_ms=max_wait_ms)

    def decode_side(spec) -> np.ndarray:
        if isinstance(spec, dict) and "b64" in spec:
            return prep(load_image(io.BytesIO(base64.b64decode(spec["b64"]))))
        return loader._load(spec)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._reply(200, {"ok": True, "metric": args.metric,
                                         "pending": batcher.pending})
            return self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/score":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                pairs = req["pairs"]
                prompt = req.get("prompt", "")
                futs = [(loader._pool.submit(decode_side, a), loader._pool.submit(decode_side, b))
                        for a, b in pairs]
                pix_a = np.concatenate([f.result() for f, _ in futs], axis=0)
                pix_b = np.concatenate([f.result() for _, f in futs], axis=0)
            except Exception as e:  # request/decode problems are the CLIENT's
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            try:
                work = batcher.submit(_Work(pix_a, pix_b, [prompt] * len(pairs)))
            except Exception as e:  # scoring/device failures are the SERVER's
                return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return self._reply(200, {"scores": work.scores})

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    return server, batcher


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--port", type=int, default=8712)
    ap.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="How long the batcher waits to fuse concurrent requests")
    ns, rest = ap.parse_known_args(argv)
    args = arg_parse(rest)
    server, _ = make_server(args, ns.port, ns.max_wait_ms)
    print(f"serving --metric {args.metric} on http://127.0.0.1:{ns.port} "
          f"(POST /score, GET /healthz)")
    server.serve_forever()


if __name__ == "__main__":
    main()
