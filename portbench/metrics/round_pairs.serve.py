"""round_pairs.serve: the mean pairs a batcher round scored in the window (the benchmark's
wrapper around the ``score_pairs`` it hands the batcher)."""


def read(r):
    rounds = r.window.rounds
    return sum(p for p, _ in rounds) / len(rounds) if rounds else None
