"""The sim-list views of the port's generators on the CPU:
``MLTrainingPipeline.generate_diverse_dataset`` here (5 systems, every
cohort present), ``generate_focused_dataset`` in
``test_torch_facade_views_focused.py``, ``quick_test_pipeline`` and
``InitialConditionGenerator.create_simulation`` in
``test_torch_facade_parts.py``.

``torch.Generator`` cannot reproduce ``jax.random``, so the two packages
draw different systems: the frames' schema is held to the JAX
package's (the same columns in the same order, the per-body columns
``mass_i`` ... counted by each draw's largest system), and the rows to
the port's own analyzers on the same draws (the simulations a view
hands its analyzer, captured): equal bit for bit.  The analyzers' depth
is cut to 2 steps (the views' 500 and 100), in both packages, by
replacing their analyzer.
"""

import re

import numpy as np
import pandas as pd

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.generators import pipeline as tpipe

STEPS = 2


def _schema(df):
    """(column, dtype) in order, per-body columns named once."""
    out = []
    for c in df.columns:
        name = re.sub(r"_\d+$", "_i", c)
        if (name, str(df[c].dtype)) not in out:
            out.append((name, str(df[c].dtype)))
    return out


class _Capture(nt.BatchStabilityAnalyzer):
    """The port's batch analyzer, keeping the simulations it is given."""

    def analyze_batch(self, simulations, show_progress=True, tangent=None):
        self.sims = list(simulations)
        return super().analyze_batch(simulations, show_progress, tangent)


def _port_pipe(n):
    pipe = nt.MLTrainingPipeline(n_systems=n, seed=1, device="cpu")
    pipe.batch_analyzer = _Capture(n_steps=STEPS, dt=0.01, mode="full")
    return pipe


def _jax_pipe(n):
    pipe = nb.MLTrainingPipeline(n_systems=n, seed=1)
    pipe.batch_analyzer = nb.BatchStabilityAnalyzer(n_steps=STEPS, dt=0.01,
                                                    mode="full")
    return pipe


def _rows_are_the_analyzer_on_the_draws(pipe, df, extra):
    sims = pipe.batch_analyzer.sims
    ref = nt.BatchStabilityAnalyzer(n_steps=STEPS, dt=0.01, mode="full"
                                    ).analyze_batch(sims, show_progress=False)
    assert len(df) == len(sims)
    pd.testing.assert_frame_equal(df.drop(columns=extra), ref)
    return sims


def test_diverse_dataset_view():
    pipe = _port_pipe(5)
    df = pipe.generate_diverse_dataset()
    sims = _rows_are_the_analyzer_on_the_draws(pipe, df, ["system_type"])
    assert all(s.cfg == tpipe._PIPE_CFG for s in sims)
    sizes = tpipe.cohort_sizes(5)
    assert df["system_type"].tolist() == sum(
        ([k] * v for k, v in sizes.items()), [])
    # the view's systems are the batched entry point's draw
    m, q, v, mask, soft, _t = pipe._population()
    counts = mask.sum(1).numpy()
    assert [s.n_bodies for s in sims] == counts.tolist()
    for i in (0, 4):
        np.testing.assert_array_equal(sims[i].mass, m[i, :counts[i]]
                                      .numpy().astype(np.float32))
    ref = _jax_pipe(5).generate_diverse_dataset()
    assert _schema(df) == _schema(ref)
