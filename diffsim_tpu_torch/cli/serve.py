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

On N cards (``torchrun --nproc_per_node N -m diffsim_tpu_torch.cli.serve ...``) rank 0 is the
leader: it runs the HTTP server and the batcher, and broadcasts each round's pixels and prompts
to the other ranks, which :func:`follow` rounds until the leader stops them. Every rank scores
its block of the round's pairs and the leader answers with the gathered scores. While idle the
leader sends a keep-alive every ``IDLE_S`` seconds, well inside the group's collective timeout.
A round that fails once the followers have joined it (a rank's error, a lost rank, a collective
that times out) leaves the ranks' collectives out of step: the leader answers that round's
requests with 500, stops serving and exits with the error, and the followers fail with it.
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

IDLE_S = 60.0  # an idle leader's keep-alive period (the group's collective timeout is 5 min)
MODULE = "diffsim_tpu_torch.cli.serve"


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
    its queued siblings. The thread scores on ``device`` (made its current CUDA device). In a
    process group ``tell(message)`` reaches the followers: ``("round", pix_a, pix_b, prompts)``
    before each round, ``("idle",)`` after ``IDLE_S`` seconds without one, ``("stop",)`` at
    :meth:`close`. Alone, a failed round fails its requests and the next round goes on; in a
    group, a failure after a round's ``tell`` (or of a ``tell``) ends the thread, and
    :meth:`join` raises it."""

    def __init__(self, score_pairs, max_batch: int, max_wait_ms: float = 5.0, *, device=None,
                 tell=None):
        self._score = score_pairs
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1e3
        self._device = device
        self._tell = tell
        self.fatal: BaseException | None = None  # what ended the thread, if not close()
        self._q: queue.Queue[_Work | None] = queue.Queue()  # None: close
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the thread after the rounds queued before this call, and the followers with
        it; the scorer is released."""
        self._q.put(None)
        self._thread.join()
        self._score = None

    def join(self) -> None:
        """Block until the thread ends: after :meth:`close`, or on a fatal error, raised here."""
        self._thread.join()
        if self.fatal is not None:
            raise self.fatal

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

    def _next(self) -> _Work | None:
        """The next queued work; in a group, a keep-alive to the followers while none comes."""
        while True:
            try:
                return self._q.get(timeout=IDLE_S if self._tell else None)
            except queue.Empty:
                self._tell(("idle",))

    def _run(self):
        if self._device is not None and self._device.type == "cuda":
            import torch

            torch.cuda.set_device(self._device)
        try:
            self._rounds()
        except BaseException as e:
            self.fatal = e
            raise

    def _rounds(self):
        carry: _Work | None = None
        closing = False
        while not closing:
            first = carry if carry is not None else self._next()
            carry = None
            if first is None:
                break
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
                if w is None:  # close after this round
                    closing = True
                    break
                if w.cancelled:
                    w.event.set()
                    continue
                if n + len(w.prompts) > self._max_batch:
                    carry = w
                    break
                batch.append(w)
                n += len(w.prompts)
            told = False  # whether the followers may have joined this round
            try:
                pix_a = np.concatenate([w.pix_a for w in batch], axis=0)
                pix_b = np.concatenate([w.pix_b for w in batch], axis=0)
                prompts = [p for w in batch for p in w.prompts]
                if self._tell is not None:
                    told = True
                    self._tell(("round", pix_a, pix_b, prompts))
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
                if told or not isinstance(e, Exception):
                    # fatal (KeyboardInterrupt/SystemExit/..., or a round the followers joined:
                    # their collectives no longer pair with the leader's): let the thread die —
                    # _wait's liveness check turns subsequent requests into errors, not hangs
                    raise
            finally:
                for w in batch:
                    w.event.set()
        if self._tell is not None:
            self._tell(("stop",))


def _broadcast(message):
    """The leader's ``message`` on every rank (``torch.distributed``, from the batcher's
    thread on the leader)."""
    import torch.distributed as dist

    box = [message]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def make_server(args, port: int, max_wait_ms: float = 5.0, *, device=None):
    """Build (ThreadingHTTPServer on 127.0.0.1, Batcher) for the parsed flags ``args``; the
    scorer runs on ``device`` (None: this rank's card). The server is not started: call
    ``.serve_forever()`` (the tests drive it from a thread), and ``Batcher.close()`` at the end,
    which in a process group also stops the followers. In a group, only rank 0 makes a server;
    the others :func:`follow`."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from diffsim_tpu_torch.cli.main import join_world
    from diffsim_tpu_torch.metrics.registry import build_metric
    from diffsim_tpu_torch.parallel import mesh

    join_world(args, device, MODULE)
    if not mesh.is_leader():
        raise RuntimeError("make_server runs on rank 0 of a process group; the other ranks "
                           "follow its rounds (serve.follow)")
    adapter = build_metric(args, device)
    loader = ImageLoader(args.image_size, preprocess=adapter.preprocess,
                         fast_decode=args.fast_decode)
    prep = adapter.preprocess or (lambda img: process_image(img, args.image_size))
    batcher = Batcher(adapter.score_pairs, max_batch=args.batch_size * 2,
                      max_wait_ms=max_wait_ms, device=adapter.scorer.device,
                      tell=_broadcast if mesh.world()[1] > 1 else None)

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


def follow(args, *, device=None):
    """A follower rank (rank > 0) of the service: build the same metric, then score this
    rank's block of each round the leader broadcasts, until it says stop. Returns the adapter
    (``adapter.score_pairs.rows`` counts the rows this rank scored)."""
    from diffsim_tpu_torch.cli.main import join_world
    from diffsim_tpu_torch.metrics.registry import build_metric

    join_world(args, device, MODULE)
    adapter = build_metric(args, device)
    while True:
        message = _broadcast(None)
        if message[0] == "stop":
            return adapter
        if message[0] == "round":
            adapter.score_pairs(*message[1:])


def main(argv=None, *, device=None):
    """Serve ``--metric`` (the flags of ``argv``, else the command line) on ``device`` (None:
    this rank's card); in a process group rank 0 serves and the others follow. Serves until
    interrupted, or until a round fails in a group, whose error it raises."""
    import argparse

    from diffsim_tpu_torch.parallel import mesh

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--port", type=int, default=8712)
    ap.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="How long the batcher waits to fuse concurrent requests")
    ns, rest = ap.parse_known_args(argv)
    args = arg_parse(rest)
    mesh.init_from_env(device)
    if not mesh.is_leader():
        follow(args, device=device)
        return
    server, batcher = make_server(args, ns.port, ns.max_wait_ms, device=device)
    print(f"serving --metric {args.metric} on http://127.0.0.1:{ns.port} "
          f"(POST /score, GET /healthz)")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        batcher.join()  # until interrupted, or a round that failed in a process group
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
