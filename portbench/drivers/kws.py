"""Live keyword spotting: ``streams`` calls staged on the card as int16
(a seeded base, rolled by ``roll_samples`` a stream, as ``live`` stages
them), served by ``MultiStreamKWS(sr, streams, block_frames)`` with one
``dispatch_from_device_buffer`` a round and then ``hits_so_far(i)`` for
every stream, the live callback a server delivers; a session is
``session_rounds`` rounds, ``finish()`` and the final flush's
``hits_so_far``, and the next session starts at once (a closed loop
replaying a backlog).  Set-up fails unless the network runs on kernel B.

The check judges the seeded sample of streams over the last session the
window served: the window ends inside a session, whose calls ``drain``
then ends at once by ``finish()`` (untimed), so the hits of those frames
are judged against the plain reference's on the same frames.  The window
also returns the hits it delivered (``hits_delivered``), which reach the
readers as ``Trace.extra``."""

from __future__ import annotations

import sys

from portbench.traffic import Live, _sync

# the session the control answers: about what a run's window serves of
# one on the H100 (10-11 rounds of 5.2 s in 51 s)
CONTROL_ROUNDS = 10


class Driver(Live):
    def __init__(self, sr, cfg, mix, gen, rng, tmp, device, spans):
        super().__init__(sr, cfg, mix, gen, rng, tmp, device, spans)
        self.hits = None
        self.rounds = mix["session_rounds"]
        self.delivered = 0

    def _server(self):
        from phnrec_tpu_torch.multistream import MultiStreamKWS
        ms = MultiStreamKWS(self.sr, self.mix["streams"],
                            block_frames=self.mix["block_frames"])
        if ms.net_path != "kernel_b":
            raise RuntimeError(
                f"the KWS network runs on {ms.net_path}, not kernel B: "
                "the cell measures the dense network step")
        return ms

    def _deliver(self, ms) -> None:
        with self.spans("hits"):
            self.delivered += sum(len(ms.hits_so_far(i))
                                  for i in range(self.mix["streams"]))

    def _round(self, ms, r: int):
        """Round r of a session: the dispatch, every stream's new hits,
        the stream synchronised; the session's last round also finishes
        it and keeps the sampled streams' hits."""
        with self.spans("dispatch"):
            ms.dispatch_from_device_buffer(self.audio, r * self.spb)
        self._deliver(ms)
        _sync(self.device)
        if r == self.mix["session_rounds"] - 1:
            with self.spans("finish"):
                self._keep(ms, r + 1)
            self._deliver(ms)

    def _keep(self, ms, rounds: int) -> None:
        """Finish the session after ``rounds`` rounds and keep the
        sampled streams' hits."""
        labels = ms.finish()
        self.rounds = rounds
        self.hits = [[(h.start_frames, h.end_frames, h.name, h.score)
                      for h in labels[s]] for s in self.pick]

    def drain(self) -> None:
        """End the session in flight at the window's end: its calls hang
        up after the rounds they were served (untimed)."""
        ms, r = self._in_flight
        if r:
            self._keep(ms, r)
        _sync(self.device)

    def window(self, seconds: float) -> dict:
        self.delivered = 0
        out = super().window(seconds)
        return dict(out, hits_delivered=self.delivered)

    def _wave(self, s: int):
        """Stream s's call as far as the judged session served it."""
        n = self.rounds * self.spb + self.cfg["vector_size"] - \
            self.cfg["vector_step"]
        return super()._wave(s)[:n]

    def judge(self, ref, judge_fn) -> dict:
        lps = [self._log_posteriors(ref, s) for s in self.pick]
        out = judge_fn(ref, lps, self.hits or [[] for _ in lps])
        for side, b, word, end in out.pop("counted", []):
            print(f"{side} hit: stream {self.pick[b]} {word} ending at "
                  f"frame {end}", file=sys.stderr)
        print(f"hits judged {out['hits']} reference {out['reference_hits']}"
              f" excused {out['excused_hits']} over {self.rounds} rounds",
              file=sys.stderr)
        return dict(out, checked=len(self.pick))

    def answers_for(self, ref) -> None:
        """The control in the program's place: the reference's hits of
        the streams the check samples, over the rounds a window of the
        cell serves on the H100 today."""
        self.rounds = CONTROL_ROUNDS
        self.hits = [[tuple(h) for h in hs] for hs in ref.hits(
            [self._log_posteriors(ref, s) for s in self.pick])]
