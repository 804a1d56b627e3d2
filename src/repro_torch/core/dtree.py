"""Pure-numpy CART decision tree (a-Tucker Sec. IV substrate).

scikit-learn is not available in this environment, and the paper's selector
only needs a small binary classifier, so we implement CART directly:
gini-impurity splits, class weights ('balanced' | 'uniform'), max_depth /
min_samples_leaf regularization, and a grid-search-with-CV helper mirroring
the paper's hyper-parameter tuning (max_depth ∈ [1,10], class_weight ∈
{'balanced','uniform'}).

Inference is vectorized (arrays of node thresholds) and also exportable as a
flat rule table for microsecond single-sample dispatch inside the st-HOSVD
mode loop (paper Fig. 7: 23–90 µs overhead).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class _Node:
    feature: int = -1          # -1 → leaf
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: int = 0             # majority class at leaf
    prob: float = 0.0          # weighted P(class=1)


@dataclass
class DecisionTree:
    max_depth: int = 6
    min_samples_leaf: int = 8
    class_weight: str = "uniform"   # 'uniform' | 'balanced'
    nodes: list[_Node] = field(default_factory=list)

    # -- training ----------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray) -> "DecisionTree":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.int64)
        if self.class_weight == "balanced":
            counts = np.bincount(y, minlength=2).astype(np.float64)
            counts[counts == 0] = 1.0
            cw = y.size / (2.0 * counts)
        else:
            cw = np.ones(2)
        w = cw[y]
        self.nodes = []
        self._build(x, y, w, depth=0)
        return self

    def _gini_gain(self, y, w, mask):
        """Weighted gini impurity decrease for a boolean split mask."""
        def gini(ys, ws):
            tot = ws.sum()
            if tot <= 0:
                return 0.0, 0.0
            p1 = ws[ys == 1].sum() / tot
            return 2.0 * p1 * (1.0 - p1), tot

        g0, t0 = gini(y, w)
        gl, tl = gini(y[mask], w[mask])
        gr, tr = gini(y[~mask], w[~mask])
        if t0 <= 0:
            return 0.0
        return g0 - (tl / t0) * gl - (tr / t0) * gr

    def _build(self, x, y, w, depth) -> int:
        idx = len(self.nodes)
        node = _Node()
        self.nodes.append(node)
        tot = w.sum()
        p1 = w[y == 1].sum() / tot if tot > 0 else 0.0
        node.value = int(p1 >= 0.5)
        node.prob = float(p1)

        if depth >= self.max_depth or y.size < 2 * self.min_samples_leaf or p1 in (0.0, 1.0):
            return idx

        best = (0.0, -1, 0.0)  # gain, feature, threshold
        n_feat = x.shape[1]
        for f in range(n_feat):
            xs = np.unique(x[:, f])
            if xs.size < 2:
                continue
            # candidate thresholds: midpoints of up to 64 quantile cuts
            if xs.size > 64:
                qs = np.quantile(xs, np.linspace(0, 1, 65)[1:-1])
            else:
                qs = (xs[:-1] + xs[1:]) / 2.0
            for t in np.unique(qs):
                mask = x[:, f] <= t
                nl = int(mask.sum())
                if nl < self.min_samples_leaf or (y.size - nl) < self.min_samples_leaf:
                    continue
                gain = self._gini_gain(y, w, mask)
                if gain > best[0] + 1e-12:
                    best = (gain, f, float(t))

        if best[1] < 0:
            return idx
        _, f, t = best
        mask = x[:, f] <= t
        node.feature = f
        node.threshold = t
        node.left = self._build(x[mask], y[mask], w[mask], depth + 1)
        node.right = self._build(x[~mask], y[~mask], w[~mask], depth + 1)
        return idx

    # -- inference -----------------------------------------------------------
    def predict_one(self, feats) -> int:
        i = 0
        nodes = self.nodes
        while nodes[i].feature >= 0:
            i = nodes[i].left if feats[nodes[i].feature] <= nodes[i].threshold else nodes[i].right
        return nodes[i].value

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        return np.fromiter((self.predict_one(row) for row in x), dtype=np.int64, count=len(x))

    def score(self, x, y) -> float:
        return float((self.predict(x) == np.asarray(y)).mean())

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    # -- (de)serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "max_depth": self.max_depth,
            "min_samples_leaf": self.min_samples_leaf,
            "class_weight": self.class_weight,
            "nodes": [
                [n.feature, n.threshold, n.left, n.right, n.value, n.prob]
                for n in self.nodes
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DecisionTree":
        t = cls(d["max_depth"], d["min_samples_leaf"], d["class_weight"])
        t.nodes = [_Node(int(f), float(th), int(l), int(r), int(v), float(p))
                   for f, th, l, r, v, p in d["nodes"]]
        return t


def grid_search_cv(
    x: np.ndarray,
    y: np.ndarray,
    max_depths=range(1, 11),
    class_weights=("uniform", "balanced"),
    n_folds: int = 3,
    seed: int = 0,
) -> tuple[DecisionTree, dict]:
    """Exhaustive grid search with k-fold CV (paper Sec. IV-B)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.int64)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y))
    folds = np.array_split(perm, n_folds)

    best_acc, best_params = -1.0, None
    for d in max_depths:
        for cw in class_weights:
            accs = []
            for k in range(n_folds):
                val = folds[k]
                trn = np.concatenate([folds[j] for j in range(n_folds) if j != k])
                t = DecisionTree(max_depth=d, class_weight=cw).fit(x[trn], y[trn])
                accs.append(t.score(x[val], y[val]))
            acc = float(np.mean(accs))
            if acc > best_acc:
                best_acc, best_params = acc, {"max_depth": d, "class_weight": cw}
    final = DecisionTree(**best_params).fit(x, y)
    return final, {"cv_accuracy": best_acc, **best_params}
