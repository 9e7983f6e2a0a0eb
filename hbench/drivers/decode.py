"""HVite's batched recognition: `algo.decode.decode_batch` on the word
network that `algo.net.compile_network` builds from the bigram's HBuild
layout and the monophone dictionary (HVite -w, tools/hvite.py's
DECODEBATCH path), a bucket a call."""

from __future__ import annotations

from htk_tpu_torch.algo.decode import decode_batch
from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
from htk_tpu_torch.ops import decode_scan as ds

from ..metrics._bounds import decode_bound
from . import _system
from ._decoding import DecodingJob

BAND = 2  # the band of a left-to-right chain: the self-loop and the step


class Job(DecodingJob):
    job = "decode"

    def build_net(self):
        return compile_network(
            _system.word_network(self.cfg, self.st),
            _system.vocab(self.st, triphones=False), self.comp,
            phone_map=word_internal_phone_map(self.comp.names))

    def call(self, feats):
        rs = decode_batch(self.net, self.comp, feats, self.lm_scale,
                          self.word_pen, precision=self.precision,
                          device=self.device)
        return [None if r is None else
                ([self.word_id[w] for w in r.words], r.times, r.score, None)
                for r in rs]

    def launch_counts(self):
        return {"decode_scan": ds.KERNEL.launches}

    def bounds(self, B, T, launched):
        n = launched.get("decode_scan", 0)
        return {"decode_scan": n * decode_bound(
            B, T, self.st.n_states, len(self.st.words), BAND)}
