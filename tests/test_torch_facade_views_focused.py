"""The sim-list view ``MLTrainingPipeline.generate_focused_dataset`` of
the port on the CPU, under the rules of ``test_torch_facade_views.py``:
the "boundary" frame's schema held to the JAX package's (both draw
their hyperparameters from numpy's global stream, seeded alike, and
their systems from their own generators), and the rows of each focus
("boundary", "stable", "chaotic") bit for bit the port's
``BatchStabilityAnalyzer`` on the simulations the view built, 2 steps
deep.
"""

import numpy as np

from test_torch_facade_views import (_jax_pipe, _port_pipe,
                                     _rows_are_the_analyzer_on_the_draws,
                                     _schema)


def test_focused_dataset_view():
    np.random.seed(4)
    pipe = _port_pipe(3)
    df = pipe.generate_focused_dataset("boundary")
    _rows_are_the_analyzer_on_the_draws(pipe, df, ["dataset_focus"])
    assert (df["dataset_focus"] == "boundary").all()
    np.random.seed(4)
    ref = _jax_pipe(3).generate_focused_dataset("boundary")
    assert _schema(df) == _schema(ref)
    for focus in ("stable", "chaotic"):
        pipe = _port_pipe(2)
        out = pipe.generate_focused_dataset(focus)
        _rows_are_the_analyzer_on_the_draws(pipe, out, ["dataset_focus"])
