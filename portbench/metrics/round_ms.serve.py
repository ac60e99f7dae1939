"""round_ms.serve: the mean wall time of a batcher round's blocking ``score_batch`` call in
the window (the benchmark's wrapper around it)."""


def read(r):
    rounds = r.window.rounds
    return sum(ms for _, ms in rounds) / len(rounds) if rounds else None
