"""Generate the checked-in GCN golden fixture (tests/data/gcn_golden.npz).

Pure-numpy derivation of the reference GCNConv math (models_gnn.py:118-184,
i.e. PyG GCNConv): Â = D̂^{-1/2} (A + I) D̂^{-1/2} with d̂(i) = deg(i) + 1,
layer = Â X W + b. Deliberately does NOT import gwen — the fixture pins
the *math*, so any drift in the framework's normalization or layer semantics
fails tests/test_models.py::test_gcn_golden_fixture.

Graph: 5-node undirected path 0-1-2-3-4 (degrees 1,2,2,2,1 → d̂ 2,3,3,3,2).
Run from the repo root: python tests/data/make_gcn_golden.py
"""

import numpy as np

N, F_IN, F_OUT = 5, 3, 2

# Undirected path: both directions listed (the framework takes directed COO).
senders = np.array([0, 1, 1, 2, 2, 3, 3, 4], np.int64)
receivers = np.array([1, 0, 2, 1, 3, 2, 4, 3], np.int64)

adj = np.zeros((N, N))
adj[receivers, senders] = 1.0
a_hat = adj + np.eye(N)
d_hat = a_hat.sum(axis=1)  # [2, 3, 3, 3, 2]
d_inv_sqrt = 1.0 / np.sqrt(d_hat)
norm_adj = d_inv_sqrt[:, None] * a_hat * d_inv_sqrt[None, :]

rng = np.random.default_rng(42)
x = rng.normal(size=(N, F_IN)).round(3)
w = rng.normal(size=(F_IN, F_OUT)).round(3)
b = rng.normal(size=(F_OUT,)).round(3)

expected_agg = norm_adj @ x
expected_layer = norm_adj @ (x @ w) + b

np.savez(
    "tests/data/gcn_golden.npz",
    senders=senders.astype(np.int32),
    receivers=receivers.astype(np.int32),
    num_nodes=np.int32(N),
    x=x.astype(np.float64),
    w=w.astype(np.float64),
    b=b.astype(np.float64),
    norm_adj=norm_adj,
    expected_agg=expected_agg,
    expected_layer=expected_layer,
)
print("wrote tests/data/gcn_golden.npz")
print("d_hat:", d_hat)
print("expected_agg:\n", expected_agg)
