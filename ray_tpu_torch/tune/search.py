"""Port of ``ray_tpu/tune/search.py``.

Search-space primitives + the basic variant generator.

Counterpart of the reference's search space API (reference:
python/ray/tune/search/sample.py — tune.grid_search/choice/uniform;
variant generation tune/search/basic_variant.py).  Minimal but same shapes:
grid_search expands cartesian; samplers draw per num_samples.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Any, Dict, List


class _GridSearch:
    def __init__(self, values):
        self.values = list(values)


class _Sampler:
    def sample(self, rng: random.Random):
        raise NotImplementedError


class _Choice(_Sampler):
    def __init__(self, values):
        self.values = list(values)

    def sample(self, rng):
        return rng.choice(self.values)


class _Uniform(_Sampler):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class _LogUniform(_Sampler):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


class _Randint(_Sampler):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


def grid_search(values) -> _GridSearch:
    return _GridSearch(values)


def choice(values) -> _Choice:
    return _Choice(values)


def uniform(low: float, high: float) -> _Uniform:
    return _Uniform(low, high)


def loguniform(low: float, high: float) -> _LogUniform:
    return _LogUniform(low, high)


def randint(low: int, high: int) -> _Randint:
    return _Randint(low, high)


def generate_variants(param_space: Dict[str, Any], num_samples: int = 1,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """Expand a param space into concrete trial configs: the cartesian
    product of every grid_search, repeated num_samples times with samplers
    re-drawn each repeat (reference: basic_variant.py semantics)."""
    rng = random.Random(seed)

    grid_keys: List[str] = []
    grid_values: List[List[Any]] = []

    def find_grids(space, prefix=""):
        for k, v in space.items():
            path = f"{prefix}{k}"
            if isinstance(v, _GridSearch):
                grid_keys.append(path)
                grid_values.append(v.values)
            elif isinstance(v, dict):
                find_grids(v, f"{path}/")

    find_grids(param_space)

    def materialize(space, assignment, prefix=""):
        out = {}
        for k, v in space.items():
            path = f"{prefix}{k}"
            if isinstance(v, _GridSearch):
                out[k] = assignment[path]
            elif isinstance(v, _Sampler):
                out[k] = v.sample(rng)
            elif isinstance(v, dict):
                out[k] = materialize(v, assignment, f"{path}/")
            else:
                out[k] = v
        return out

    combos = list(itertools.product(*grid_values)) if grid_keys else [()]
    variants = []
    for _ in range(max(num_samples, 1)):
        for combo in combos:
            assignment = dict(zip(grid_keys, combo))
            variants.append(materialize(param_space, assignment))
    return variants


class TPESearcher:
    """Tree-structured Parzen Estimator — an OWN implementation, not a
    wrapper (the reference wraps hyperopt/optuna/bohb,
    python/ray/tune/search/).  Classic TPE: completed trials split into a
    good quantile and the rest; numeric params get Parzen (Gaussian-mixture)
    densities l(x) over the good points and g(x) over the bad; candidates
    are drawn from l and ranked by log l(x) - log g(x); categoricals use
    smoothed count ratios.  Until ``n_initial`` results exist it behaves as
    random search.

    Supports uniform/loguniform/randint/choice dimensions (grid_search is a
    basic-variant concept and is rejected).
    """

    def __init__(self, n_initial: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0):
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._space: Dict[str, Any] = {}
        self._metric: str = ""
        self._mode: str = "max"
        self._obs: List[Any] = []  # (score, flat_config)

    # ------------------------------------------------------------- set-up
    def setup(self, param_space: Dict[str, Any], metric: str,
              mode: str) -> None:
        self._metric = metric
        self._mode = mode
        self._space = {}
        # a fresh experiment must not inherit another run's observations
        self._obs = []

        def walk(space, prefix=""):
            for k, v in space.items():
                path = f"{prefix}{k}"
                if isinstance(v, _GridSearch):
                    raise ValueError(
                        "TPESearcher does not accept grid_search dimensions; "
                        "use choice() instead")
                if isinstance(v, _Sampler):
                    self._space[path] = v
                elif isinstance(v, dict):
                    walk(v, f"{path}/")
                else:
                    self._space[path] = v  # constant

        walk(param_space)
        if metric is None:
            raise ValueError("TPESearcher needs TuneConfig(metric=...)")

    # ------------------------------------------------------------ suggest
    def suggest(self) -> Dict[str, Any]:
        if len(self._obs) < self.n_initial:
            flat = {k: (v.sample(self._rng) if isinstance(v, _Sampler) else v)
                    for k, v in self._space.items()}
            return self._unflatten(flat)
        good, bad = self._split()
        # per-dimension observation stats depend only on (good, bad): build
        # once, reuse across every candidate draw
        stats = {key: self._dim_stats(key, dim, good, bad)
                 for key, dim in self._space.items()
                 if isinstance(dim, _Sampler)}
        best_flat, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            flat, score = {}, 0.0
            for key, dim in self._space.items():
                if not isinstance(dim, _Sampler):
                    flat[key] = dim
                    continue
                value, ll = self._draw_dim(dim, stats[key])
                flat[key] = value
                score += ll
            if score > best_score:
                best_flat, best_score = flat, score
        return self._unflatten(best_flat)

    def on_trial_complete(self, config: Dict[str, Any], score) -> None:
        if score is None:
            return
        score = float(score)
        if not math.isfinite(score):
            # NaN/inf (diverged trials) would scramble the good/bad ranking
            # (NaN comparisons are always False) — drop them like hyperopt
            return
        if self._mode == "min":
            score = -score
        self._obs.append((score, self._flatten(config)))

    # ------------------------------------------------------------ internals
    def _split(self):
        ranked = sorted(self._obs, key=lambda o: -o[0])
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:] or ranked[n_good - 1:]

    def _dim_values(self, obs, key, transform):
        return [transform(o[1][key]) for o in obs if key in o[1]]

    def _dim_stats(self, key, dim, good, bad):
        """Per-dimension modelling state shared by all candidate draws."""
        if isinstance(dim, _Choice):
            k = len(dim.values)
            g_counts = [1.0] * k  # +1 smoothing
            b_counts = [1.0] * k
            index = {self._cat_key(v): i for i, v in enumerate(dim.values)}
            for o in good:
                i = index.get(self._cat_key(o[1].get(key)))
                if i is not None:
                    g_counts[i] += 1
            for o in bad:
                i = index.get(self._cat_key(o[1].get(key)))
                if i is not None:
                    b_counts[i] += 1
            return ("cat", g_counts, b_counts)

        # numeric: uniform / loguniform / randint in (possibly log) space
        if isinstance(dim, _LogUniform):
            lo, hi = math.log(dim.low), math.log(dim.high)
        elif isinstance(dim, _Randint):
            lo, hi = float(dim.low), float(dim.high - 1)
        else:
            lo, hi = float(dim.low), float(dim.high)
        fwd = math.log if isinstance(dim, _LogUniform) else float
        span = max(hi - lo, 1e-12)
        g_vals = self._dim_values(good, key, fwd) or [lo + span / 2]
        b_vals = self._dim_values(bad, key, fwd) or [lo + span / 2]

        def bandwidth(vals):
            # Silverman over the GROUP's spread (tightens as the good points
            # cluster), floored at span/min(100, n+2) like hyperopt's
            # adaptive-Parzen minimum: without the floor the kernel collapses
            # onto an early local best and resamples the same point forever.
            n = len(vals)
            floor = span / min(100, n + 2)
            if n < 2:
                return span / 4
            mean = sum(vals) / n
            std = math.sqrt(sum((v - mean) ** 2 for v in vals) / (n - 1))
            return max(1.06 * std * n ** -0.2, floor)

        return ("num", lo, hi, span, g_vals, b_vals,
                bandwidth(g_vals), bandwidth(b_vals))

    def _draw_dim(self, dim, stats):
        if stats[0] == "cat":
            _, g_counts, b_counts = stats
            k = len(dim.values)
            g_tot = sum(g_counts)
            b_tot = sum(b_counts)
            # sample from the good distribution
            r = self._rng.random() * g_tot
            acc = 0.0
            pick = k - 1
            for i in range(k):
                acc += g_counts[i]
                if r <= acc:
                    pick = i
                    break
            ll = math.log(g_counts[pick] / g_tot) - \
                math.log(b_counts[pick] / b_tot)
            return dim.values[pick], ll

        _, lo, hi, span, g_vals, b_vals, g_sigma, b_sigma = stats
        if isinstance(dim, _Randint):
            def inv(x):
                return min(max(int(round(x)), dim.low), dim.high - 1)
        elif isinstance(dim, _LogUniform):
            inv = math.exp
        else:
            inv = float
        # Uniform prior kernel mixed into BOTH densities (hyperopt does the
        # same): without it the good-mixture collapses onto the early best
        # point and never explores again (premature convergence).
        prior = 1.0 / (len(g_vals) + 1)
        if self._rng.random() < prior:
            x = self._rng.uniform(lo, hi)
        else:
            center = self._rng.choice(g_vals)
            x = min(max(self._rng.gauss(center, g_sigma), lo), hi)

        def density(vals, sigma, p):
            return p / span + (1 - p) * self._parzen(x, vals, sigma)

        ll = math.log(density(g_vals, g_sigma, prior)) - \
            math.log(density(b_vals, b_sigma, 1.0 / (len(b_vals) + 1)))
        return inv(x), ll

    @staticmethod
    def _parzen(x, values, sigma):
        s = sum(math.exp(-0.5 * ((x - v) / sigma) ** 2) for v in values)
        return max(s / (len(values) * sigma * math.sqrt(2 * math.pi)), 1e-300)

    @staticmethod
    def _cat_key(v):
        try:
            hash(v)
            return v
        except TypeError:
            return repr(v)

    # flat "a/b" keys <-> nested dicts (matches generate_variants paths)
    def _flatten(self, config, prefix=""):
        out = {}
        for k, v in config.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                out.update(self._flatten(v, f"{path}/"))
            else:
                out[path] = v
        return out

    def _unflatten(self, flat):
        out: Dict[str, Any] = {}
        for path, v in flat.items():
            parts = path.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return out
