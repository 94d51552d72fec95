"""NamedTrajectory: the knot-point trajectory container, as a JAX pytree.

Batched re-design of the reference's NamedTrajectories container (surface
inferred from call sites, see SURVEY.md §2b and
/root/reference/test/test_utils.jl:109-117).  Differences by design:

- data is TIME-MAJOR, shape (T, dim): each row is one knot point.  Batched
  solver updates are then contiguous (T, dim) tensors; vmap adds a leading
  batch axis.  (The reference uses (dim, T) column-major Julia layout.)
- the container is immutable/functional: `update` returns a new trajectory
  (the reference's `update!` mutates).
- bounds/initial/final/goal values are pytree leaves, so a trajectory can be
  passed straight through jit/vmap boundaries.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NamedTrajectory", "derivative"]


def derivative(data, dt):
    """Forward finite difference along the time axis (axis 0).

    data: (T, k); dt: scalar or (T,) or (T, 1).  Returns (T, k) with the last
    row duplicated (the final derivative entry is unconstrained by the
    derivative-chain defects, matching the reference's usage at
    /root/reference/src/trajectory_initialization.jl:234).
    """
    data = jnp.asarray(data)
    dt = jnp.asarray(dt)
    if dt.ndim == 0:
        dts = jnp.full((data.shape[0] - 1, 1), dt)
    else:
        dts = dt.reshape(-1)[: data.shape[0] - 1, None]
    diff = (data[1:] - data[:-1]) / dts
    return jnp.concatenate([diff, diff[-1:]], axis=0)


def _as_bound_pair(bound, size, dtype=np.float64):
    """Normalize a bound spec to (lo, hi) arrays of shape (size,)."""
    if isinstance(bound, tuple) and len(bound) == 2:
        lo, hi = bound
        lo = np.broadcast_to(np.asarray(lo, dtype=dtype), (size,)).copy()
        hi = np.broadcast_to(np.asarray(hi, dtype=dtype), (size,)).copy()
        return lo, hi
    arr = np.broadcast_to(np.asarray(bound, dtype=dtype), (size,)).copy()
    return -arr, arr


@jax.tree_util.register_pytree_node_class
class NamedTrajectory:
    """Named components over T knot points plus metadata.

    Parameters
    ----------
    components : mapping name -> array (T, k) (or (T,) for scalar components)
    controls : names of pure control components (no dynamics defect rows)
    timestep : float (fixed time) or component name (free time)
    bounds : mapping name -> bound (scalar | (k,) | (lo, hi))
    initial / final : mapping name -> pinned values at t=0 / t=T-1
    goal : mapping name -> target values (terminal objective data)
    global_data : mapping name -> (k,) global (knot-independent) variables
    """

    def __init__(
        self,
        components: Mapping[str, Any],
        *,
        controls: Sequence[str] | str = (),
        timestep: float | str = 1.0,
        bounds: Mapping[str, Any] | None = None,
        initial: Mapping[str, Any] | None = None,
        final: Mapping[str, Any] | None = None,
        goal: Mapping[str, Any] | None = None,
        global_data: Mapping[str, Any] | None = None,
    ):
        if isinstance(controls, str):
            controls = (controls,)
        comps = OrderedDict()
        arrays = []
        T = None
        offset = 0
        for name, arr in components.items():
            arr = jnp.asarray(arr)
            if arr.ndim == 1:
                arr = arr[:, None]
            if T is None:
                T = arr.shape[0]
            assert arr.shape[0] == T, (
                f"component {name!r} has {arr.shape[0]} knots, expected {T}"
            )
            k = arr.shape[1]
            comps[name] = (offset, offset + k)
            arrays.append(arr)
            offset += k
        self._components = comps
        self.data = jnp.concatenate(arrays, axis=1)
        self.T = int(T)
        self.dim = int(offset)

        controls = tuple(controls)
        if isinstance(timestep, str):
            assert timestep in comps, f"timestep component {timestep!r} missing"
            if timestep not in controls:
                controls = controls + (timestep,)
        self.controls = controls
        self.timestep = timestep

        def _normdict(d, pad_bounds=False):
            out = OrderedDict()
            for name, val in (d or {}).items():
                size = comps[name][1] - comps[name][0]
                if pad_bounds:
                    out[name] = _as_bound_pair(val, size)
                else:
                    out[name] = np.broadcast_to(
                        np.asarray(val, dtype=np.float64), (size,)
                    ).copy()
            return out

        self.bounds = _normdict(bounds, pad_bounds=True)
        self.initial = _normdict(initial)
        self.final = _normdict(final)
        self.goal = _normdict(goal)
        self.global_data = OrderedDict(
            (k, jnp.asarray(v)) for k, v in (global_data or {}).items()
        )

    # ------------------------------------------------------------------ #
    # pytree protocol
    # ------------------------------------------------------------------ #
    def tree_flatten(self):
        bkeys = tuple(self.bounds)
        ikeys = tuple(self.initial)
        fkeys = tuple(self.final)
        gkeys = tuple(self.goal)
        glkeys = tuple(self.global_data)
        children = (
            self.data,
            tuple(self.global_data[k] for k in glkeys),
        )
        aux = (
            tuple(self._components.items()),
            self.controls,
            self.timestep,
            self.T,
            self.dim,
            bkeys,
            tuple(
                (tuple(lo.tolist()), tuple(hi.tolist()))
                for lo, hi in self.bounds.values()
            ),
            ikeys,
            tuple(tuple(v.tolist()) for v in self.initial.values()),
            fkeys,
            tuple(tuple(v.tolist()) for v in self.final.values()),
            gkeys,
            tuple(tuple(v.tolist()) for v in self.goal.values()),
            glkeys,
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        (
            comp_items,
            controls,
            timestep,
            T,
            dim,
            bkeys,
            bvals,
            ikeys,
            ivals,
            fkeys,
            fvals,
            gkeys,
            gvals,
            glkeys,
        ) = aux
        data, glvals = children
        obj._components = OrderedDict(comp_items)
        obj.data = data
        obj.controls = controls
        obj.timestep = timestep
        obj.T = T
        obj.dim = dim
        obj.bounds = OrderedDict(
            (k, (np.asarray(lo), np.asarray(hi)))
            for k, (lo, hi) in zip(bkeys, bvals)
        )
        obj.initial = OrderedDict(
            (k, np.asarray(v)) for k, v in zip(ikeys, ivals)
        )
        obj.final = OrderedDict((k, np.asarray(v)) for k, v in zip(fkeys, fvals))
        obj.goal = OrderedDict((k, np.asarray(v)) for k, v in zip(gkeys, gvals))
        obj.global_data = OrderedDict(zip(glkeys, glvals))
        return obj

    # ------------------------------------------------------------------ #
    # accessors
    # ------------------------------------------------------------------ #
    @property
    def names(self) -> tuple:
        return tuple(self._components)

    @property
    def components(self) -> OrderedDict:
        return self._components

    def comp_slice(self, name: str) -> slice:
        start, stop = self._components[name]
        return slice(start, stop)

    def comp_size(self, name: str) -> int:
        start, stop = self._components[name]
        return stop - start

    @property
    def state_names(self) -> tuple:
        return tuple(n for n in self._components if n not in self.controls)

    @property
    def control_names(self) -> tuple:
        return self.controls

    @property
    def dims(self) -> dict:
        d = {n: self.comp_size(n) for n in self._components}
        d["states"] = sum(self.comp_size(n) for n in self.state_names)
        d["controls"] = sum(self.comp_size(n) for n in self.controls)
        return d

    @property
    def global_dim(self) -> int:
        return sum(int(np.prod(v.shape)) for v in self.global_data.values())

    def __getitem__(self, name):
        if isinstance(name, str):
            return self.data[..., self.comp_slice(name)]
        raise KeyError(name)

    def __getattr__(self, name):
        comps = self.__dict__.get("_components")
        if comps is not None and name in comps:
            return self.data[..., self.comp_slice(name)]
        raise AttributeError(name)

    def get_timesteps(self):
        """(T,) vector of timestep durations."""
        if isinstance(self.timestep, str):
            return self[self.timestep][..., 0]
        return jnp.full((self.T,), self.timestep, dtype=self.data.dtype)

    def get_times(self):
        """(T,) knot times, starting at 0."""
        dts = self.get_timesteps()
        return jnp.concatenate(
            [jnp.zeros_like(dts[..., :1]), jnp.cumsum(dts[..., :-1], axis=-1)],
            axis=-1,
        )

    def duration(self):
        dts = self.get_timesteps()
        return jnp.sum(dts[..., :-1], axis=-1)

    # ------------------------------------------------------------------ #
    # functional updates
    # ------------------------------------------------------------------ #
    def update(self, name: str, new_data) -> "NamedTrajectory":
        """Return a new trajectory with component `name` replaced."""
        new_data = jnp.asarray(new_data)
        if new_data.ndim == 1:
            new_data = new_data[:, None]
        data = self.data.at[..., self.comp_slice(name)].set(new_data)
        return self.with_data(data)

    def with_data(self, data, global_data=None) -> "NamedTrajectory":
        obj = object.__new__(NamedTrajectory)
        obj.__dict__.update(self.__dict__)
        obj.data = data
        if global_data is not None:
            obj.global_data = OrderedDict(global_data)
        return obj

    def copy(self) -> "NamedTrajectory":
        return self.with_data(self.data)

    def plot(self, names=None, *, path=None, **kwargs):
        """Per-component subplots over time (the reference's NamedTrajectories
        plot recipe, docs/literate/man/ipopt_callbacks.jl:61-64)."""
        from ..utils.plotting import plot_trajectory

        return plot_trajectory(self, names, path=path, **kwargs)

    def flatten(self):
        """The flat decision vector Z = [vec(data); globals] (datavec analog)."""
        parts = [self.data.reshape(*self.data.shape[:-2], -1)]
        for v in self.global_data.values():
            parts.append(jnp.asarray(v).reshape(*parts[0].shape[:-1], -1))
        return jnp.concatenate(parts, axis=-1)

    @property
    def datavec(self):
        return self.flatten()

    def __repr__(self):
        comps = ", ".join(
            f"{n}:{self.comp_size(n)}" for n in self._components
        )
        return (
            f"NamedTrajectory(T={self.T}, dim={self.dim}, [{comps}], "
            f"controls={self.controls}, timestep={self.timestep!r})"
        )
