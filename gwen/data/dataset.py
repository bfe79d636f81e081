"""Runtime datasets: member-graph and CNN views over the ensemble archive.

Reference parity:

* ``load_data`` (utils.py:478-520): open train/test zarr → array transposed to
  ``(time, member, height, ncells)``.
* ``load_config_and_data`` (utils.py:445-475): + optional coarsening.
* ``GraphDataset`` (utils.py:164-211): nodes = ensemble members; node features
  = flattened ``height × ncells`` field; member indices shuffled once, first
  ``member_split`` are inputs, rest are targets marked by a boolean
  ``target_mask``. The reference feeds *all* member features to the model and
  applies the mask only in the loss; ``mask_inputs=True`` additionally zeroes
  target-member features in the input (principled extension).
* ``ConvDataset`` (utils.py:50-161): per time step, ``(x, y)`` member stacks,
  with a ``simplify`` 1-in/1-out mode (utils.py:92-100).

Everything returns static-shape numpy arrays ready for ``device_put``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gwen.config import DataConfig, TrainConfig
from gwen.data import zarrstore
from gwen.data.preprocess import coarsen_block_mean


def load_split(config: DataConfig, which: str = "train"):
    """Load the train or test store as (time, member, height, ncells) float32.

    With ``config.lazy`` the returned value is a
    :class:`~gwen.data.lazy.LazyField` — time steps stream from the
    store on access (the reference's dask laziness, utils.py:478-520), so
    host memory scales with the per-step slab, not the archive. The datasets
    below consume either form.
    """
    path = config.data_train if which == "train" else config.data_test
    arr = zarrstore.open_array(path)
    want = ["time", "member", "height", "ncells"]
    if config.lazy:
        from gwen.data.lazy import LazyField

        return LazyField(arr, want_dims=want, coarsen=config.coarsen), arr.meta
    values = arr.read().astype(np.float32)
    dims = list(arr.dims)
    if set(want) <= set(dims):
        values = np.transpose(values, [dims.index(d) for d in want])
    if config.coarsen > 1:
        values = coarsen_block_mean(values, config.coarsen, axes=(2, 3))
    return values, arr.meta


def load_data(config: DataConfig):
    """(train, test, meta) — utils.py:478-520 + coarsening (utils.py:445-475)."""
    train, meta = load_split(config, "train")
    test, _ = load_split(config, "test")
    return train, test, meta


@dataclass
class MemberGraphDataset:
    """Ensemble-member graph view: one sample per time step.

    ``features(t)`` returns ``(members, height*ncells)`` node features;
    ``target_mask`` is fixed per dataset instance (reference shuffles member
    indices once at construction, utils.py:181-186).
    """

    data: np.ndarray  # (time, member, height, ncells)
    member_split: int
    seed: int = 42
    simplify: bool = False
    mask_inputs: bool = False

    def __post_init__(self) -> None:
        t, m, h, c = self.data.shape
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(m)
        if self.simplify:
            # 1 input / 1 target member (utils.py:92-100).
            self.input_indices = perm[:1]
            self.target_indices = perm[1:2]
        else:
            self.input_indices = np.sort(perm[: self.member_split])
            self.target_indices = np.sort(perm[self.member_split :])
        mask = np.zeros(m, bool)
        mask[self.target_indices] = True
        self.target_mask = mask

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.data.shape[1]

    @property
    def num_features(self) -> int:
        return self.data.shape[2] * self.data.shape[3]

    def features(self, t: int) -> np.ndarray:
        x = self.data[t].reshape(self.num_nodes, self.num_features)
        if self.mask_inputs:
            x = x.copy()
            x[self.target_mask] = 0.0
        return x

    def raw_features(self, t: int) -> np.ndarray:
        """Unmasked node features — the loss target when mask_inputs=True."""
        return self.data[t].reshape(self.num_nodes, self.num_features)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        node_batch_size: int = 0,
    ):
        """Yield (x, target_mask) batches over time steps, each
        ``(batch, members, features)``; the last partial batch is dropped so
        shapes stay static under jit.

        ``node_batch_size > 0`` reproduces the reference's NeighborLoader
        semantics (models_gnn.py:351-356, batch_size=21 member-nodes): on the
        fully-connected member graph a 2-hop neighborhood of any seed set is
        the whole graph, so it reduces to a full forward with the loss
        restricted to a random node subset — the yielded mask is
        ``target_mask ∧ sampled-nodes``.
        """
        t = len(self)
        order = np.arange(t)
        rng = np.random.default_rng(seed)
        if shuffle:
            rng.shuffle(order)
        for start in range(0, t - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            x = np.stack([self.features(i) for i in idx])
            mask = self.target_mask
            if node_batch_size and node_batch_size < self.num_nodes:
                sampled = np.zeros(self.num_nodes, bool)
                sampled[rng.choice(self.num_nodes, node_batch_size, replace=False)] = True
                if not (mask & sampled).any():  # keep at least one target node
                    sampled[rng.choice(np.nonzero(mask)[0])] = True
                mask = mask & sampled
            if self.mask_inputs:
                # Loss must see the UNMASKED ground truth at target nodes.
                target = np.stack([self.raw_features(i) for i in idx])
                yield x, mask, target
            else:
                yield x, mask


@dataclass
class ConvEnsembleDataset:
    """CNN view: per time step, input members as channels → target members.

    Reference ``ConvDataset`` (utils.py:50-161) + ``collate_fn``
    (models_cnn.py:404-408): x is ``(batch, members_in, height, ncells)`` and
    y ``(batch, members_out, height, ncells)``.
    """

    data: np.ndarray  # (time, member, height, ncells)
    member_split: int
    seed: int = 42
    simplify: bool = False

    def __post_init__(self) -> None:
        m = self.data.shape[1]
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(m)
        if self.simplify:
            self.input_indices = perm[:1]
            self.target_indices = perm[1:2]
        else:
            self.input_indices = np.sort(perm[: self.member_split])
            self.target_indices = np.sort(perm[self.member_split :])

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        return self.data[t, self.input_indices], self.data[t, self.target_indices]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        t = len(self)
        order = np.arange(t)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, t - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            x = np.stack([self.data[i, self.input_indices] for i in idx])
            y = np.stack([self.data[i, self.target_indices] for i in idx])
            yield x, y


@dataclass
class MeshEnsembleDataset:
    """Mesh-scale next-step pairs (north-star task): fields
    ``(time, member, nodes, channels)`` → batches of ``(x_t, x_{t+1})`` drawn
    across time × member, with static shapes (last partial batch dropped)."""

    fields: np.ndarray  # (time, member, nodes, channels)

    def __post_init__(self) -> None:
        t, m, _, _ = self.fields.shape
        pairs = [(ti, mi) for mi in range(m) for ti in range(t - 1)]
        self._pairs = np.asarray(pairs)

    def __len__(self) -> int:
        return len(self._pairs)

    @property
    def num_nodes(self) -> int:
        return self.fields.shape[2]

    @property
    def num_channels(self) -> int:
        return self.fields.shape[3]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        order = np.arange(len(self._pairs))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = self._pairs[order[start : start + batch_size]]
            x = self.fields[idx[:, 0], idx[:, 1]]
            y = self.fields[idx[:, 0] + 1, idx[:, 1]]
            yield x, y

    def trajectory_batches(
        self, batch_size: int, horizon: int, shuffle: bool = False, seed: int = 0
    ):
        """(x0, traj) batches for rollout-horizon training: traj is
        ``(batch, horizon, nodes, channels)`` — the next ``horizon`` states."""
        t, m = self.fields.shape[:2]
        starts = [(ti, mi) for mi in range(m) for ti in range(t - horizon)]
        starts = np.asarray(starts)
        order = np.arange(len(starts))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s0 in range(0, len(order) - batch_size + 1, batch_size):
            idx = starts[order[s0 : s0 + batch_size]]
            x0 = self.fields[idx[:, 0], idx[:, 1]]
            traj = np.stack(
                [self.fields[ti + 1 : ti + 1 + horizon, mi] for ti, mi in idx]
            )
            yield x0, traj


def make_datasets(
    data_cfg: DataConfig, train_cfg: TrainConfig, kind: str = "graph"
) -> tuple:
    """Convenience: load both splits and wrap them (orchestrator helper)."""
    train, test, meta = load_data(data_cfg)
    cls = MemberGraphDataset if kind == "graph" else ConvEnsembleDataset
    mk = lambda d: cls(  # noqa: E731
        data=d,
        member_split=train_cfg.member_split,
        seed=train_cfg.seed,
        simplify=train_cfg.simplify,
    )
    return mk(train), mk(test), meta
