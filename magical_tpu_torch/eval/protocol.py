"""Multi-task evaluation protocol.

The counterpart of ``magical_tpu/eval/protocol.py`` (after the reference's
magical/evaluation.py), over the port's registry: given a demo env, evaluate
a policy on the demo env and all its test variants with mean / 95% t-CI /
std aggregation, plus a LaTeX table emitter.  The t-interval is computed
directly (scipy/statsmodels-free) with the same two-sided Student-t
construction statsmodels' DescrStatsW.tconfint_mean uses.

`do_eval` returns a pandas DataFrame where pandas is importable and the
list of its rows (dicts) otherwise; `latexify_results` takes either.
"""

from __future__ import annotations

import abc
import collections
import math
import warnings

import numpy as np


def _t_ppf(q, df):
    """Student-t quantile via the incomplete-beta inverse (good to ~1e-8;
    replicates scipy.stats.t.ppf for the CI computation)."""
    # use the relationship with the regularised incomplete beta function;
    # numerically invert with bisection (df >= 1, q in (0.5, 1)).
    if df <= 0:
        return float('nan')

    def cdf(x):
        # Student-t CDF via continued-fraction betainc
        ibt = _betainc(df / 2.0, 0.5, df / (df + x * x))
        return 1.0 - 0.5 * ibt if x > 0 else 0.5 * ibt

    lo, hi = 0.0, 1e3
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < q:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _betainc(a, b, x):
    """Regularised incomplete beta I_x(a, b) (Lentz continued fraction)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    lbeta = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
             + a * math.log(x) + b * math.log(1.0 - x))
    front = math.exp(lbeta)
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1.0 - x) / b


def _betacf(a, b, x, max_iter=200, eps=3e-14):
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < 1e-30:
        d = 1e-30
    d = 1.0 / d
    h = d
    for m in range(1, max_iter + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < 1e-30:
            d = 1e-30
        c = 1.0 + aa / c
        if abs(c) < 1e-30:
            c = 1e-30
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < 1e-30:
            d = 1e-30
        c = 1.0 + aa / c
        if abs(c) < 1e-30:
            c = 1e-30
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < eps:
            break
    return h


def tconfint_mean(scores, alpha=0.05):
    """DescrStatsW(scores).tconfint_mean(alpha, 'two-sided') equivalent."""
    scores = np.asarray(scores, dtype=np.float64)
    n = len(scores)
    mean = scores.mean()
    if n < 2:
        return (float('nan'), float('nan'))
    sem = scores.std(ddof=1) / math.sqrt(n)
    tq = _t_ppf(1.0 - alpha / 2.0, n - 1)
    return (mean - tq * sem, mean + tq * sem)


class EvaluationProtocol(abc.ABC):
    """evaluation.py:13-98."""
    _called_init = False

    def __init__(self, demo_env_name, n_rollouts):
        from magical_tpu_torch.api.registry import (
            DEMO_ENVS_TO_TEST_ENVS_MAP, register_envs)
        register_envs()
        self.n_rollouts = n_rollouts
        self.demo_env_name = demo_env_name
        self.test_env_names = [
            demo_env_name, *DEMO_ENVS_TO_TEST_ENVS_MAP[demo_env_name]]
        self._called_init = True

    @property
    @abc.abstractmethod
    def run_id(self):
        ...

    @abc.abstractmethod
    def obtain_scores(self, env_name):
        ...

    def _summarise(self, env_name, scores):
        """One result row (dict) for a batch of episode scores."""
        n_got = len(scores)
        if n_got != self.n_rollouts:
            if n_got < self.n_rollouts:
                raise ValueError(
                    f'{type(self).__name__}.obtain_scores({env_name!r}) '
                    f'produced {n_got} episode scores; the protocol '
                    f'requires exactly n_rollouts={self.n_rollouts}')
            warnings.warn(
                f'obtain_scores({env_name!r}) produced {n_got} > '
                f'n_rollouts={self.n_rollouts} scores; keeping the first '
                f'{self.n_rollouts} and dropping the rest')
            scores = scores[:self.n_rollouts]
        lo, hi = tconfint_mean(scores, 0.05)
        return collections.OrderedDict(
            demo_env=self.demo_env_name,
            test_env=env_name,
            mean_score=float(np.mean(scores)),
            ci95_lower=lo,
            ci95_upper=hi,
            std_score=float(np.std(scores, ddof=1)),
            run_id=self.run_id,
        )

    def do_eval(self, verbose=False):
        if not self._called_init:
            raise ValueError(
                f'{type(self).__name__} never ran '
                'EvaluationProtocol.__init__; call super().__init__('
                'demo_env_name=..., n_rollouts=...) from your subclass')
        rows = [self._summarise(env_name, self.obtain_scores(env_name))
                for env_name in self.test_env_names]
        try:
            import pandas as pd
            frame = pd.DataFrame.from_records(rows)
        except ImportError:
            frame = rows
        if verbose:
            print(f"Final mean scores for '{self.run_id}':")
            if not isinstance(frame, list):
                print(frame[['test_env', 'mean_score', 'ci95_lower',
                             'ci95_upper']])
        return frame


def _rows(eval_data):
    """The result rows of a do_eval frame: a list of row dicts as is, a
    DataFrame's records."""
    if isinstance(eval_data, list):
        return eval_data
    return eval_data.to_dict('records')


def _single_row(rows, id_column, run_id, env_name):
    """The unique result row for (run_id, test_env); error otherwise."""
    sel = [r for r in rows
           if r[id_column] == run_id and r['test_env'] == env_name]
    if len(sel) != 1:
        raise ValueError(
            f'expected exactly one row with {id_column}={run_id!r} and '
            f'test_env={env_name!r}, found {len(sel)} — are the values in '
            f'column {id_column!r} unique per run?')
    return sel[0]


def latexify_results(eval_data, id_column='run_id'):
    """Render a do_eval result (one or more runs; a DataFrame or a list of
    row dicts) as a LaTeX booktabs table.

    Output shape follows the reference's table (evaluation.py:101-154):
    one column per test env, one row per run id, cells "mean (± std)".
    The reference emits \\bottomrule + \\end{tabular} INSIDE its row loop
    (malformed for >1 run id); here the footer is emitted once, as in the
    JAX package.
    """
    rows = _rows(eval_data)
    test_envs = list(dict.fromkeys(r['test_env'] for r in rows))
    lines = [
        r'\centering',
        r'\begin{tabular}{l@{\hspace{1em}}%s}' % ('c' * len(test_envs)),
        r'\toprule',
        ' & '.join([r'\textbf{Randomisation}']
                   + [r'\textbf{%s}' % e for e in test_envs]) + r'\\',
        r'\midrule',
    ]
    for run_id in dict.fromkeys(r[id_column] for r in rows):
        cells = []
        for env_name in test_envs:
            row = _single_row(rows, id_column, run_id, env_name)
            cells.append('%.2f ($\\pm$ %.2f)'
                         % (row['mean_score'], row['std_score']))
        lines.append(' & '.join([r'\textbf{%s}' % run_id] + cells) + r'\\')
    lines += [r'\bottomrule', r'\end{tabular}']
    return '\n'.join(lines) + '\n'
