"""Quantum system containers as JAX pytrees.

Batched re-design of the reference's PiccoloQuantumObjects system types
(call-site surface: /root/reference/src/quantum_system_templates/transmons.jl:98-102,
cats.jl:47-52, README.md:110).  Each system stores *stacked* drive Hamiltonians
and their real iso generators so that H(a) = H_drift + sum_j a_j H_drives[j]
is a single tensor contraction — one batched product, vmappable over control
batches.

Device-residency design: ONLY the real iso generators (G_*, D_*) are device
arrays / pytree leaves — the entire collocation compute path runs on the real
isomorphism.  The complex Hamiltonians and dissipators are host-side numpy
(carried through flatten/unflatten as bytes): they are never needed on
device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .isomorphisms import iso_D, iso_G
from .operators import lift

__all__ = [
    "QuantumSystem",
    "OpenQuantumSystem",
    "CompositeQuantumSystem",
    "QuantumSystemCoupling",
]


def _stack_drives(H_drives, levels):
    if H_drives is None or (
        isinstance(H_drives, (list, tuple)) and len(H_drives) == 0
    ):
        return np.zeros((0, levels, levels), dtype=np.complex128)
    if isinstance(H_drives, (list, tuple)):
        return np.stack(
            [np.asarray(H, dtype=np.complex128) for H in H_drives]
        )
    H_drives = np.asarray(H_drives, dtype=np.complex128)
    if H_drives.ndim == 2:
        H_drives = H_drives[None]
    return H_drives


def _to_bytes(arr: np.ndarray):
    arr = np.ascontiguousarray(arr)
    return (arr.tobytes(), arr.shape, str(arr.dtype))


def _from_bytes(blob):
    data, shape, dtype = blob
    return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class QuantumSystem:
    """Closed quantum system: H(a) = H_drift + sum_j a_j H_drives[j].

    Fields (mirroring the reference API surface):
      - H_drift: (N, N) complex numpy (host)
      - H_drives: (n_drives, N, N) complex numpy (host), stacked
      - G_drift: (2N, 2N) real device array — iso generator of -i H_drift
      - G_drives: (n_drives, 2N, 2N) real device arrays
      - n_drives, levels: static ints
      - params: static metadata dict
    """

    H_drift: Any
    H_drives: Any
    G_drift: Any
    G_drives: Any
    n_drives: int
    levels: int
    params: Any

    def __init__(self, H_drift=None, H_drives=None, *, params=None):
        # Convenience: QuantumSystem([H1, H2]) means drift-free system
        # (reference pattern: QuantumSystem(H_drives::Vector)).
        if H_drives is None and isinstance(H_drift, (list, tuple)):
            H_drives, H_drift = H_drift, None
        if H_drift is None:
            if H_drives is None:
                raise ValueError("need at least one of H_drift / H_drives")
            first = (
                H_drives[0]
                if isinstance(H_drives, (list, tuple))
                else H_drives
            )
            n = np.asarray(first).shape[-1]
            H_drift = np.zeros((n, n), dtype=np.complex128)
        H_drift = np.asarray(H_drift, dtype=np.complex128)
        levels = H_drift.shape[-1]
        H_drives = _stack_drives(H_drives, levels)
        object.__setattr__(self, "H_drift", H_drift)
        object.__setattr__(self, "H_drives", H_drives)
        object.__setattr__(self, "G_drift", jnp.asarray(np.asarray(iso_G(H_drift))))
        if H_drives.shape[0] > 0:
            G_dr = np.stack([np.asarray(iso_G(H)) for H in H_drives])
        else:
            G_dr = np.zeros((0, 2 * levels, 2 * levels))
        object.__setattr__(self, "G_drives", jnp.asarray(G_dr))
        object.__setattr__(self, "n_drives", int(H_drives.shape[0]))
        object.__setattr__(self, "levels", int(levels))
        object.__setattr__(self, "params", dict(params) if params else {})

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        children = (self.G_drift, self.G_drives)
        aux = (
            self.n_drives,
            self.levels,
            tuple(
                sorted(self.params.items(), key=lambda kv: str(kv[0]))
            ),
            _to_bytes(self.H_drift),
            _to_bytes(self.H_drives),
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        object.__setattr__(obj, "G_drift", children[0])
        object.__setattr__(obj, "G_drives", children[1])
        object.__setattr__(obj, "n_drives", aux[0])
        object.__setattr__(obj, "levels", aux[1])
        object.__setattr__(obj, "params", dict(aux[2]))
        object.__setattr__(obj, "H_drift", _from_bytes(aux[3]))
        object.__setattr__(obj, "H_drives", _from_bytes(aux[4]))
        return obj

    # -- physics -----------------------------------------------------------
    def hamiltonian(self, a):
        """H(a) = H_drift + sum_j a_j H_drives[j] (host-side complex)."""
        a = np.asarray(a)
        if self.n_drives == 0:
            return self.H_drift
        return self.H_drift + np.tensordot(
            a.astype(self.H_drives.dtype), self.H_drives, axes=1
        )

    def generator(self, a):
        """Real iso generator G(a) = G_drift + sum_j a_j G_drives[j]
        (device path; traceable)."""
        a = jnp.asarray(a)
        if self.n_drives == 0:
            return self.G_drift
        return self.G_drift + jnp.tensordot(
            a.astype(self.G_drives.dtype), self.G_drives, axes=1
        )

    @property
    def iso_dim(self) -> int:
        return 2 * self.levels


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class OpenQuantumSystem(QuantumSystem):
    """Open (Lindblad) quantum system with dissipators.

    Adds host-side stacked dissipators and device real iso Lindblad
    superoperators:
      - L_dissipators: (k, N, N) complex numpy (host)
      - D_drift: (2N^2, 2N^2) real device — iso superoperator of
        -i[H_drift, .] + dissipators
      - D_drives: (n_drives, 2N^2, 2N^2) real device — iso superoperators of
        -i[H_j, .]
    Mirrors the OpenQuantumSystem surface used at
    /root/reference/src/quantum_system_templates/cats.jl:47-52.
    """

    L_dissipators: Any = None
    D_drift: Any = None
    D_drives: Any = None

    # levels above which the dense (2N^2, 2N^2) iso superoperators are NOT
    # materialized (a 39-level cat x buffer system would eat ~220 MB of
    # device memory in superoperators alone); rollouts then go through the
    # matrix-free `lindblad_action` + Krylov expv path
    SUPEROP_MAX_LEVELS = 32

    def __init__(self, H_drift=None, H_drives=None, L_dissipators=None, *,
                 params=None, materialize_superops=None):
        super().__init__(H_drift, H_drives, params=params)
        Ls = L_dissipators if L_dissipators is not None else []
        if isinstance(Ls, (list, tuple)):
            Ls = (
                np.stack([np.asarray(L, dtype=np.complex128) for L in Ls])
                if len(Ls)
                else np.zeros((0, self.levels, self.levels), dtype=np.complex128)
            )
        else:
            Ls = np.asarray(Ls, dtype=np.complex128)
        object.__setattr__(self, "L_dissipators", Ls)
        if materialize_superops is None:
            materialize_superops = self.levels <= self.SUPEROP_MAX_LEVELS
        if materialize_superops:
            object.__setattr__(
                self,
                "D_drift",
                jnp.asarray(np.asarray(iso_D(self.H_drift, list(Ls)))),
            )
            if self.n_drives:
                D_dr = np.stack(
                    [np.asarray(iso_D(Hj, [])) for Hj in self.H_drives]
                )
            else:
                n2 = 2 * self.levels**2
                D_dr = np.zeros((0, n2, n2))
            object.__setattr__(self, "D_drives", jnp.asarray(D_dr))
        else:
            object.__setattr__(self, "D_drift", None)
            object.__setattr__(self, "D_drives", None)

    def tree_flatten(self):
        children = (self.G_drift, self.G_drives, self.D_drift, self.D_drives)
        aux = (
            self.n_drives,
            self.levels,
            tuple(sorted(self.params.items(), key=lambda kv: str(kv[0]))),
            _to_bytes(self.H_drift),
            _to_bytes(self.H_drives),
            _to_bytes(self.L_dissipators),
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        names = ("G_drift", "G_drives", "D_drift", "D_drives")
        for name, child in zip(names, children):
            object.__setattr__(obj, name, child)
        object.__setattr__(obj, "n_drives", aux[0])
        object.__setattr__(obj, "levels", aux[1])
        object.__setattr__(obj, "params", dict(aux[2]))
        object.__setattr__(obj, "H_drift", _from_bytes(aux[3]))
        object.__setattr__(obj, "H_drives", _from_bytes(aux[4]))
        object.__setattr__(obj, "L_dissipators", _from_bytes(aux[5]))
        return obj

    def lindblad_generator(self, a):
        """Real iso Lindblad superoperator D(a) = D_drift + sum_j a_j D_drives[j]."""
        if self.D_drift is None:
            raise ValueError(
                f"dense superoperators were not materialized for this "
                f"{self.levels}-level system (> SUPEROP_MAX_LEVELS="
                f"{self.SUPEROP_MAX_LEVELS}); use the matrix-free "
                f"lindblad_action + expv rollout path, or construct with "
                f"materialize_superops=True"
            )
        a = jnp.asarray(a)
        if self.n_drives == 0:
            return self.D_drift
        return self.D_drift + jnp.tensordot(
            a.astype(self.D_drives.dtype), self.D_drives, axes=1
        )

    def lindblad_action(self, a, rho_iso_vec):
        """Apply D(a) to an iso-vec density WITHOUT forming the
        superoperator: O(k N^3) complex matmuls instead of an O(N^4)-entry
        dense superoperator row — the matvec behind the Krylov expv rollout
        on large cat/composite Hilbert spaces
        (/root/reference/src/quantum_system_templates/cats.jl:9-53).

        Traceable: the complex Hamiltonian/dissipators enter as captured
        REAL constants (complex arithmetic inside jit is fine).
        """
        N = self.levels
        Hr = jnp.asarray(np.ascontiguousarray(self.H_drift.real))
        Hi = jnp.asarray(np.ascontiguousarray(self.H_drift.imag))
        a = jnp.asarray(a)
        dtype = rho_iso_vec.dtype
        if self.n_drives:
            HdR = jnp.asarray(np.ascontiguousarray(self.H_drives.real))
            HdI = jnp.asarray(np.ascontiguousarray(self.H_drives.imag))
            Hr = Hr + jnp.tensordot(a.astype(dtype), HdR.astype(dtype), axes=1)
            Hi = Hi + jnp.tensordot(a.astype(dtype), HdI.astype(dtype), axes=1)
        cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        H = (Hr + 1j * Hi).astype(cdtype)

        # density iso-vec layout (isomorphisms.density_to_iso_vec):
        # [Re(vec(rho)); Im(vec(rho))] with column-major vec
        n2 = N * N
        vec = (rho_iso_vec[:n2] + 1j * rho_iso_vec[n2:]).astype(cdtype)
        rho = vec.reshape(N, N).T  # undo column-major vec

        drho = -1j * (H @ rho - rho @ H)
        if self.L_dissipators.shape[0]:
            Lr = jnp.asarray(np.ascontiguousarray(self.L_dissipators.real))
            Li = jnp.asarray(np.ascontiguousarray(self.L_dissipators.imag))
            Ls = (Lr + 1j * Li).astype(cdtype)
            Ldag = jnp.conj(jnp.swapaxes(Ls, -1, -2))
            LdL = jnp.einsum("kij,kjl->il", Ldag, Ls)
            drho = drho + jnp.einsum(
                "kij,jl,kml->im", Ls, rho, jnp.conj(Ls)
            )
            drho = drho - 0.5 * (LdL @ rho + rho @ LdL)

        vec_out = drho.T.reshape(-1)  # column-major vec
        return jnp.concatenate(
            [jnp.real(vec_out), jnp.imag(vec_out)]
        ).astype(dtype)


@dataclasses.dataclass(frozen=True)
class QuantumSystemCoupling:
    """A coupling term in a composite system.

    Mirrors the constructor signature used at
    /root/reference/src/quantum_system_templates/transmons.jl:163-170.
    `op` is the full-Hilbert-space coupling operator.
    """

    op: Any
    g: float = 0.0
    pair: tuple = ()
    subsystem_levels: tuple = ()
    coupling_type: Any = None
    params: Any = dataclasses.field(default_factory=dict)


@jax.tree_util.register_pytree_node_class
class CompositeQuantumSystem(QuantumSystem):
    """Tensor-product composite of subsystems plus coupling terms.

    H_drift = sum_i lift(H_drift_i) + sum_c coupling.op ; drives are the
    lifted drives of each subsystem in order.  Mirrors
    /root/reference/src/quantum_system_templates/transmons.jl:198-242.

    The `subsystems`/`couplings` attributes are build-time conveniences and
    are not preserved through jit flatten/unflatten round trips.
    """

    def __init__(self, subsystems: Sequence[QuantumSystem], couplings: Sequence[QuantumSystemCoupling] = (), *, params=None):
        levels = [int(s.levels) for s in subsystems]
        H_drift = 0
        for i, sub in enumerate(subsystems):
            H_drift = H_drift + lift(np.asarray(sub.H_drift), i, levels)
        for c in couplings:
            H_drift = H_drift + np.asarray(c.op)
        H_drives = []
        for i, sub in enumerate(subsystems):
            for j in range(sub.n_drives):
                H_drives.append(lift(np.asarray(sub.H_drives[j]), i, levels))
        merged = dict(params or {})
        merged.setdefault("subsystem_levels", tuple(levels))
        super().__init__(H_drift, H_drives, params=merged)
        # static extras (not part of the pytree)
        self.__dict__["subsystems"] = tuple(subsystems)
        self.__dict__["couplings"] = tuple(couplings)
        self.__dict__["subsystem_levels"] = tuple(levels)
