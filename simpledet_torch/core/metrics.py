"""Training metrics with ignore-label semantics: a copy of
`simpledet_tpu/core/metrics.py` (numpy only), kept in the port so that it
imports nothing of the JAX package.

Each metric reads named arrays from a step's aux and loss dict (the port's
train forward returns `rpn_cls_logit`, `rpn_label`, `bbox_cls_logit` and
`bbox_label` as aux, the JAX package's names), sums and counts on the host,
and reports the mean at log frequency. The ignore label is -1. Predictions
are [..., C] logits or probabilities; labels are [...] floats.
`from_config` builds the config's `metric_list`, which `read_config`
records as stand-ins of `core.detection_metric`.
"""
import numpy as np


class EvalMetric:
    def __init__(self, name, output_names, label_names=()):
        self.name = name
        self.output_names = list(output_names)
        self.label_names = list(label_names)
        self.reset()

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0.0

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def _fetch(self, aux):
        return [np.asarray(aux[n]) for n in self.output_names]


class AccWithIgnore(EvalMetric):
    """argmax accuracy over non-ignored labels (pred [..., C], label [...])."""

    def update(self, aux):
        pred, label = self._fetch(aux)[:2]
        cls = pred.reshape(-1, pred.shape[-1]).argmax(-1)
        label = label.reshape(-1)
        keep = label != -1
        self.sum_metric += float((cls[keep] == label[keep]).sum())
        self.num_inst += float(keep.sum())


class FgAccWithIgnore(EvalMetric):
    """accuracy over foreground (label > 0) entries only."""

    def update(self, aux):
        pred, label = self._fetch(aux)[:2]
        cls = pred.reshape(-1, pred.shape[-1]).argmax(-1)
        label = label.reshape(-1)
        keep = label > 0
        self.sum_metric += float((cls[keep] == label[keep]).sum())
        self.num_inst += float(keep.sum())


class CeWithIgnore(EvalMetric):
    """mean cross-entropy over non-ignored labels (pred = probs or logits)."""

    def update(self, aux):
        pred, label = self._fetch(aux)[:2]
        p = pred.reshape(-1, pred.shape[-1]).astype(np.float64)
        # treat as logits if rows don't sum to ~1
        if not np.allclose(p[:8].sum(-1), 1.0, atol=1e-3):
            p = p - p.max(-1, keepdims=True)
            p = np.exp(p)
            p = p / p.sum(-1, keepdims=True)
        label = label.reshape(-1)
        keep = label != -1
        idx = label[keep].astype(np.int64)
        ll = -np.log(np.maximum(p[keep, idx], 1e-12))
        self.sum_metric += float(ll.sum())
        self.num_inst += float(keep.sum())


class ScalarLoss(EvalMetric):
    """mean of a scalar loss output."""

    def update(self, aux):
        val = self._fetch(aux)[0]
        self.sum_metric += float(val)
        self.num_inst += 1.0


class L1(EvalMetric):
    """mean of an (already reduced) L1 loss output per non-ignored label."""

    def update(self, aux):
        vals = self._fetch(aux)
        loss = vals[0]
        if len(vals) > 1:
            label = vals[1].reshape(-1)
            n = float((label != -1).sum())
        else:
            n = 1.0
        self.sum_metric += float(np.asarray(loss).sum())
        self.num_inst += max(n, 1.0) if len(vals) > 1 else 1.0


class CompositeMetric:
    def __init__(self, metrics):
        self.metrics = metrics

    def update(self, aux):
        for m in self.metrics:
            try:
                m.update(aux)
            except KeyError:
                pass

    def reset(self):
        for m in self.metrics:
            m.reset()

    def get(self):
        return [m.get() for m in self.metrics]


METRICS = {c.__name__: c for c in (AccWithIgnore, FgAccWithIgnore,
                                   CeWithIgnore, ScalarLoss, L1)}


def from_config(metric_list):
    """CompositeMetric of a config's recorded metric_list (each a stand-in
    with the class name and arguments the config gave); a metric the port
    does not have raises NotImplementedError naming it."""
    out = []
    for m in metric_list:
        name = type(m).__name__
        if name not in METRICS:
            raise NotImplementedError(f"metric {name} is not ported")
        out.append(METRICS[name](*m.args, **m.kwargs))
    return CompositeMetric(out)
