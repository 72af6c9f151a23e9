"""The floors of the roofline shares: the least time one NVIDIA H100 could
take for a kernel call, whatever implements it.

A call reads each row it asks for once and writes each row's answer
once, and reads each triangle once. The row and triangle sizes are those
of the queries' inputs and answers as the queries define them, fixed
here and not read from the program's layout:
  K1 closest hit: a ray (origin, direction: 24 B; tmin, tmax: 8 B; three
     excluded ids: 12 B) in, (t, triangle) out (8 B);
  K2 any hit: the same ray in, one byte out;
  K3 cone minima: a cone (origin, axis, major axis: 36 B; eccentricity,
     radius, slope, reach: 16 B; excluded id: 4 B; 16 boundaries: 64 B)
     in, 16 minima and a count out (68 B);
  a triangle: three corners, 36 B.
No count of a spatial query's operations bounds every implementation,
so the floor has no operations term: bytes over the published HBM3
bandwidth.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth
PEAK_BYTES_PER_S = 3.35e12

ROW_BYTES = {"k1": 44 + 8, "k2": 44 + 1, "k3": 120 + 68}
TRI_BYTES = 36

# the kernels' names as the device trace gives them
KERNEL_NAMES = {"k1": "closest_hit_kernel", "k2": "any_hit_kernel",
                "k3": "cone_minz_kernel"}


def floor_bytes(kind, rows, tris):
    """Bytes a call of `kind` that asks for `rows` rows over `tris`
    triangles must move at least."""
    return rows * ROW_BYTES[kind] + tris * TRI_BYTES


def floor_seconds(kind, calls):
    """The summed floor of calls [(rows, tris)]."""
    return sum(floor_bytes(kind, int(r), int(t)) for r, t in calls) \
        / PEAK_BYTES_PER_S
