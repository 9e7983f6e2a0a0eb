"""HDecode -N: pass 1 with a hybrid LSTMP-HMM. The job of `lattice_ann`
(the two stages of the port's HDecode -N batch: `algo.nnet.hybrid_outp`
on the batch's padded frames, then `generate_lattice_batch(
state_scores_list=...)` on the factored LV loop; its lattices, its kept
score rows, `gc.freeze` before each call) with the projected LSTM in
place of the DNN.

The net is generated from the seed: `lstm_layers` LSTMP layers of `cells`
cells with peepholes and a `projection`-unit recurrent projection
(models/ann.LSTMPLayer, gate rows i, f, c, o), one frame of `dim`
features a step, and an affine softmax layer with one output a tied
state of the set, in `lattice_ann.target_order`; frame t scores with the
output at t + `out_delay`. W_x ~ N(0, input_gain^2 / fan-in), W_r ~ N(0,
recur_gain^2 / n_r), W_rm ~ N(0, proj_gain^2 / n_c), each peephole N(0,
peep_sd^2), each gate bias N(0, bias_sd^2) and + forget_bias on the
forget gate's, the softmax layer's weights and biases N(0, output_gain^2
/ n_r), the priors a Dirichlet(1) draw. The configuration file says why
each value.

The check is the lattice_ann job's with the LSTM's float64 reference
(`reference/lstmp.py`, a block of sampled requests stepped side by side)
in place of the DNN's, and

  lstm_gap  the widest |program - reference| over the kept score rows
            (the last frame and 3 seeded frames of every utterance, taken
            inside the timed call from the plane it computed), in units of
            LSTM_U x float32's rounding of the output layer's dot product,
            2^-24 x sum_k |W_jk h_k| with the reference's h. LSTM_U allows
            for the three layers' rounding, carried to the output through
            W: the recurrence is contractive (the configuration's gains),
            so a float32 run's error in h stays at a few roundings of h
            however long the utterance. TF32 in the matmuls rounds their
            inputs to 2^-11 and reads hundreds of these units.

  paths_not_best  requests whose words and times the reference scores
            below its best by more than score_gap's limit, in score_gap's
            units (float32's rounding of the running score): a best path
            to float32's precision. A float32 decoder ranks two paths by
            its own scores, each within its scoring error of the
            reference's (what score_gap reads); where the two lie closer
            than the sum of those errors it may take either, and the
            exact comparison of the other cells (1e-9 of the best) counts
            that near-tie as a wrong path. The window's log gives the
            widest gap and its request.
"""

from __future__ import annotations

import time

import torch

from htk_tpu_torch.algo.nnet import check_targets
from htk_tpu_torch.models.ann import ANNDef, ANNModule, Layer, LSTMPLayer
from htk_tpu_torch.ops import lstmp as lstmp_op

from ..metrics._lstmp_bounds import cell_bound_ms
from ..reference import decoder as ref
from ..reference import lstmp as ref_lstmp
from ..traffic.synth import _generator
from . import lattice, lattice_ann
from ._decoding import F32_U, _rel

LSTM_U = 4.0  # the unit's allowance for what precedes the output layer


def make_lstmp(cfg: dict, n_in: int, n_out: int, seed: int, device):
    """[(W_x, W_r, peep, b, W_rm)] of the LSTMP layers, the softmax layer
    (W, b) and the priors, float32 on `device`, from `seed`."""
    g = _generator(int(seed) + 3, device)

    def normal(*shape, sd):
        return torch.randn(shape, generator=g, device=device) * sd

    n_c, n_r = int(cfg["cells"]), int(cfg["projection"])
    width = n_in * (2 * int(cfg["context"]) + 1)
    layers = []
    for _ in range(int(cfg["lstm_layers"])):
        W_x = normal(4 * n_c, width, sd=cfg["input_gain"] / width ** 0.5)
        W_r = normal(4 * n_c, n_r, sd=cfg["recur_gain"] / n_r ** 0.5)
        peep = normal(3, n_c, sd=cfg["peep_sd"])
        b = normal(4 * n_c, sd=cfg["bias_sd"])
        b[n_c:2 * n_c] += float(cfg["forget_bias"])
        W_rm = normal(n_r, n_c, sd=cfg["proj_gain"] / n_c ** 0.5)
        layers.append((W_x, W_r, peep, b, W_rm))
        width = n_r
    sd = cfg["output_gain"] / n_r ** 0.5
    out = (normal(n_out, n_r, sd=sd), normal(n_out, sd=sd))
    e = -torch.log(torch.rand((n_out,), generator=g, device=device,
                              dtype=torch.float64))  # Dirichlet(1)
    return layers, out, (e / e.sum()).to(torch.float32)


def lstmp_ann(cfg: dict, layers, out, priors, order) -> ANNDef:
    """The program's ANNDef of `make_lstmp`'s net, output k scoring pool
    state order[k]."""
    def host(a):
        return a.cpu().numpy()

    return ANNDef(
        name="lstmp", context=int(cfg["context"]),
        out_delay=int(cfg["out_delay"]),
        layers=[LSTMPLayer(*(host(a) for a in l)) for l in layers]
        + [Layer(weight=host(out[0]), bias=host(out[1]),
                 activation="SOFTMAX")],
        target_priors=host(priors),
        target_names=[f"st{k}" for k in order])


class Job(lattice_ann.Job):
    job = "lattice"

    def __init__(self, cell, seed, device, control=False):
        # the lattice job's set-up; lattice_ann's own builds a DNN
        lattice.Job.__init__(self, cell, seed, device, control)
        t = time.perf_counter()
        cfg = self.cfg
        self.order = lattice_ann.target_order(self.st)
        self.layers, self.out, self.priors = make_lstmp(
            cfg, int(cfg["dim"]), len(self.order), seed, device)
        ann = lstmp_ann(cfg, self.layers, self.out, self.priors, self.order)
        check_targets(ann, self.comp)
        self.ann, self.model = ann, ANNModule(ann, device)
        mats = [m for W_x, W_r, _, _, W_rm in self.layers
                for m in (W_x, W_r, W_rm)] + [self.out[0]]
        self.flops_per_frame = 2.0 * sum(m.numel() for m in mats)
        self.ann_rows = {}
        self.idx = []
        self._phase("LSTM", t)

    def launch_counts(self):
        return dict(super().launch_counts(),
                    lstmp_cell=lstmp_op.KERNEL.launches)

    def bounds(self, B, T, launched):
        return dict(super().bounds(B, T, launched),
                    lstmp_cell=launched.get("lstmp_cell", 0) * cell_bound_ms(
                        B, int(self.cfg["cells"])))

    def check(self):
        """As the lattice_ann job's check, with the reference LSTM's scores
        in place of the DNN's and `lstm_gap` (the module's docstring)."""
        pick = self.sample()
        loop = self.reference()
        net = ref_lstmp.LSTMP(self.layers, self.out, self.priors,
                              int(self.cfg["out_delay"]), self.device)
        pool = torch.as_tensor(self.order, device=self.device)
        lim = self.wl["limits"]
        got = {k: 0.0 for k in lim}
        blk = int(self.wl["check_block"])
        margin = float(lim["score_gap"])
        widest = (0.0, -1)  # (path gap in score_gap's units, request)
        for i0 in range(0, len(pick), blk):
            part = pick[i0:i0 + blk]
            lls = []
            for i, (s, h) in zip(part, net.run(
                    [self.pool.feats[i] for i in part])):
                fr, rows = self.ann_rows[i]
                fr = torch.as_tensor(fr, device=self.device)
                unit = LSTM_U * F32_U * net.scale(h[fr])
                gap = ((rows.to(torch.float64) - s[fr]).abs() / unit).max()
                got["lstm_gap"] = max(got["lstm_gap"], float(gap))
                ll = s.new_full((s.shape[0], int(self.cfg["n_tied"])),
                                float("-inf"))
                ll[:, pool] = s
                lls.append(ll)
            best, ends = ref.best_scores(loop, lls, ends=True)
            res = [self.results[i] for i in part]
            path = ref.path_scores(loop, lls, [(r[0], r[1]) for r in res],
                                   self.st.word_states)
            for b, (i, r) in enumerate(zip(part, res)):
                n = int(self.pool.lengths[i])
                lead = ends[b, :n].max(dim=1).values
                self.mag = float(lead[torch.isfinite(lead)].abs().max())
                rounding = F32_U * max(abs(best[b]), self.mag) * n / 2
                got["score_gap"] = max(got["score_gap"],
                                       _rel(r[2], best[b], rounding))
                gap = float(_rel(path[b], best[b], rounding))
                got["paths_not_best"] += float(gap > margin)
                widest = max(widest, (gap, i))
                self.check_output(got, loop, r[3], lls[b], ends[b],
                                  best[b], rounding)
            del lls, ends
        self.window_log.append(f"check: widest path gap {widest[0]!r} units "
                               f"(request {widest[1]}), limit {margin!r}")
        self.checked = len(pick)
        return [(k, got[k], float(lim[k])) for k in lim]
