"""Port parity for the wave path under the JAX package's other cone
queries, where they differ: the wave box with a 1,280-triangle icosphere
inside it (1,292 triangles), 16×16 × 2 spp, depth 4, rendered by
wave_tracer_tpu_torch under each WT_CONE_QUERY mode from the bridged JAX
bake, and held against the JAX package's render under the same mode at
PERF.md §2's wave bars.

On this scene the modes differ from one another (the K-capped sets see
at most K = 8 encounters, 2 passes keep 32 candidates, the clustered
query 12 clusters): the JAX package's own renders move their diffusive
traversals by up to 4% between modes, so each mode is held against its
own reference. "mxu" keeps the default's minima (K3's plain version on
the CPU), bit for bit.
"""

import pytest

from test_torch_cone_queries import (COUNTERS, assert_wave_bars,
                                     icosphere_renders)
from test_torch_threads import cap_torch_threads

cap_torch_threads()

# the default (and mxu) on this scene: tests/test_torch_cone_queries.py
JAX_MODES = ("topk", "2pass", "clustered")


@pytest.fixture(scope="module")
def renders():
    """JAX renders per mode (each a fresh scene, so a fresh trace that
    reads the mode) and the port's from the bridged bake of the first."""
    return icosphere_renders(JAX_MODES, JAX_MODES)


@pytest.mark.parametrize("mode", JAX_MODES)
def test_icosphere_wave_render_under_cone_query_matches_jax(mode, renders):
    jax_out, port_out, T = renders
    assert T == 1292
    jimg, jst = jax_out[mode]
    img, st = port_out[mode]
    assert st["mode"] == "wave-compact"
    assert_wave_bars(img, jimg, st, jst, COUNTERS + ("cone_tri_tests",))
