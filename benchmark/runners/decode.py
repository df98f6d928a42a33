"""Decode rounds: a round decodes every resident column once through its
decoder, on streams that stay on the device; rounds run back to back, one
synchronise a round.

The comparison reads one whole round drawn from the seed in the window's
first half (``kept_round``); the outputs of the round before it have one
value a group scribbled before they are freed, so a decode that skipped
its work and handed back a recycled or the same buffer reads wrong.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import reference
from ..yardstick import GROUP
from . import Window, launched, spans, sync

SCRIBBLE = 0x5A5A5A5A


def scribble(outputs: list[torch.Tensor], lane: int, group: int) -> None:
    """Flip bits of one value a group of each output."""
    for out in outputs:
        out.view(-1)[lane::group] ^= SCRIBBLE


class Job:
    def __init__(self, residents, sut, device, kept_round: int, lane: int):
        self.residents, self.sut, self.device = residents, sut, device
        self.kept_round, self.lane = kept_round, lane

    def window(self, seconds: float, trace: bool, keep: bool = True) -> Window:
        """Rounds back to back for ``seconds``. With ``keep``, the outputs
        of round ``kept_round`` (at least 1) are kept for the comparison."""
        sut, span = self.sut, spans(trace)
        kept_round = self.kept_round if keep else None
        w = Window()
        outs = None
        t0 = time.perf_counter()
        while True:
            if w.rounds and time.perf_counter() - t0 >= seconds:
                break
            if outs is not None and kept_round is not None and w.rounds == kept_round:
                scribble(outs, self.lane, GROUP)
            outs = None  # the previous round's outputs go before this round's come
            try:
                round_outs = []
                for res in self.residents:
                    w.attempted += 1
                    before = sut.launches()
                    with span("decode:" + res.name):
                        a = time.perf_counter()
                        round_outs.append(sut.decode(res))
                        w.issue_s.append(time.perf_counter() - a)
                    launched(sut, w, before)
                sync(self.device)
            except Exception as e:  # noqa: BLE001 - a failed call is counted and reported, the window goes on
                if w.failure(e):
                    break
                continue
            if w.rounds == kept_round:
                w.kept, w.kept_round = round_outs, w.rounds
            w.rounds += 1
            w.decoded_bytes += sum(res.decoded_bytes() for res in self.residents)
            outs = round_outs
        w.seconds = time.perf_counter() - t0
        if keep and w.kept is None and outs is not None:  # a window too short for the drawn round
            w.kept, w.kept_round = outs, w.rounds - 1
        return w


def prepare(cell, residents, seed: int, seconds: float, sut, device) -> Job:
    """Warm up (two rounds), then draw the kept round and the scribbled
    lane from the seed."""
    for _ in range(2):
        a = time.perf_counter()
        outs = [sut.decode(r) for r in residents]
        sync(device)
        round_s = time.perf_counter() - a
    del outs
    choose = np.random.default_rng([int(seed) % 2**64, 1])
    rounds_min = max(1, math.floor(0.5 * seconds / max(round_s, 1e-6)))
    kept_round = 1 + int(choose.integers(rounds_min))
    return Job(residents, sut, device, kept_round, int(choose.integers(GROUP)))


def check(columns: dict, w: Window) -> list:
    """Values of the kept round that differ from the reference's (none
    when the window kept no round)."""
    if w.kept is None:
        return []
    wrong = 0
    for (name, values), out in zip(columns.items(), w.kept):
        ref = reference.decode(values)
        wrong += int(torch.count_nonzero(out[: ref.shape[0]] != ref))
    w.kept = None
    return [("wrong_values", wrong, 0)]
