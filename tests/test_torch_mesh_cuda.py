"""``parallel/mesh.py`` on the card: under the port's gloo group (two
processes of ``tests/torch_dist_worker.py`` sharing one GPU) the default
``make_mesh()`` holds a host batch's shards and replicas on each
process's card, with the rows the CPU mesh gives (read with
``to_local``: a card mesh's DTensor collectives crash under gloo, see
``parallel/mesh.py``).

Needs an NVIDIA GPU (marker ``cuda``) and skips without one; the file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_mesh_cuda.py -m cuda --noconftest
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from nbodysimproject_tpu_torch import SimConfig, build_batch  # noqa: E402
from torch_dist_worker import population, run_workers  # noqa: E402

pytestmark = pytest.mark.cuda


def test_mesh_places_shards_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run_workers(str(tmp_path), "cuda", 300)
    cfg = SimConfig(integrator_mode="verlet")
    st, _dy = build_batch(*population(), cfg, 1.0, 1e-3, 0.0, 0.01)
    full = torch.cat([st.pos, st.pos[-1:]]).numpy()
    for r, z in enumerate(res):
        assert list(z["devices"]) == ["cuda", "cuda"]
        assert np.array_equal(z["local_pos"], full[3 * r:3 * r + 3])
        assert np.array_equal(z["replicated_pos"], full)
