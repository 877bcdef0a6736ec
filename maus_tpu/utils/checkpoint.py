"""Checkpoint / resume (SURVEY.md §5.4).

The reference has no serialization — ``evolve()`` runs to completion or dies.
Here the entire solver state is one pytree (:class:`EvolveCarry`: population SoA,
strategy scalars, cached factorization, PRNG keys), so checkpointing is a flat
leaf dump and resume is re-entering the jitted loop with the loaded carry.

Format: a single ``.npz`` with positional leaf arrays — no pickling. Complex
leaves are stored as separate real/imag float planes (``leaf_XXXX_re`` /
``leaf_XXXX_im``), and both save and load route complex data through
:mod:`maus_tpu.utils.xfer`. Loading requires
a structural template (built by ``init_carry`` from the same config), which
doubles as a schema check: leaf count, shape, or dtype mismatches fail loudly
instead of resuming garbage.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .xfer import to_device_complex, to_host_complex

FORMAT_VERSION = 3   # v3: EvolveCarry gained the trailing refactor_psi scalar
#                      (v2 files load with it defaulted; see load_state)


def _is_complex(x) -> bool:
    return jnp.issubdtype(jnp.asarray(x).dtype if not hasattr(x, "dtype")
                          else x.dtype, jnp.complexfloating)


def _restore_leaf(got_host, want, want_dtype, is_complex: bool):
    """Place a loaded host leaf per the template leaf (VERDICT r3 #5):

    * multi-device template sharding → ``device_put`` the HOST array directly
      with that sharding: placement slices host-side per shard, so no single
      device ever materializes the full leaf (a resumed mesh carry's factors
      may not fit one device — that is the memory scaling the mesh exists
      for).
    * single-device templates stay UNCOMMITTED (committing them would make
      jit reject mixing them with mesh-sharded operands) and complex leaves
      go through :mod:`maus_tpu.utils.xfer`.
    """
    sharding = getattr(want, "sharding", None)
    if sharding is not None and len(sharding.device_set) > 1:
        return jax.device_put(np.asarray(got_host, want_dtype), sharding)
    if is_complex:
        return to_device_complex(got_host, want_dtype)
    return jnp.asarray(got_host)


def _leaf_shape(x) -> tuple:
    """Template leaf shape; works for arrays AND jax.ShapeDtypeStruct
    templates (load_state accepts abstract templates so resume does not have
    to pay a throwaway init_carry factorization just to learn shapes)."""
    s = getattr(x, "shape", None)
    return tuple(s) if s is not None else tuple(np.shape(x))


def save_state(path: str, state) -> int:
    """Dump any pytree's leaves to ``path`` (.npz). Returns the leaf count.

    Complex leaves cross the host boundary as re/im float planes
    (``to_host_complex``); everything else as plain arrays.
    """
    leaves = jax.tree.leaves(state)
    arrays = {"__version__": np.asarray(FORMAT_VERSION, np.int64)}
    for i, x in enumerate(leaves):
        if _is_complex(x):
            z = to_host_complex(x)
            arrays[f"leaf_{i:04d}_re"] = np.ascontiguousarray(z.real)
            arrays[f"leaf_{i:04d}_im"] = np.ascontiguousarray(z.imag)
        else:
            arrays[f"leaf_{i:04d}"] = np.asarray(x)
    np.savez(path, **arrays)
    return len(leaves)


def load_state(path: str, template):
    """Rebuild a pytree with ``template``'s structure and the file's leaves.

    Every mismatch — leaf count, shape, or dtype (e.g. a checkpoint written
    under a different x64/precision config) — raises ``ValueError``; nothing is
    silently cast.
    """
    with np.load(path) as data:
        files = set(data.files)
        version = int(data["__version__"]) if "__version__" in files else 1
        t_leaves, treedef = jax.tree.flatten(template)
        # count distinct leaf indices present in the file
        idxs = set()
        for n in files:
            if n.startswith("leaf_"):
                idxs.add(int(n[5:9]))
        legacy_pad = False
        if version <= 2 and len(idxs) == len(t_leaves) - 1 and \
                idxs == set(range(len(t_leaves) - 1)) and \
                _leaf_shape(t_leaves[-1]) == () and \
                not jnp.issubdtype(
                    getattr(t_leaves[-1], "dtype", np.float32),
                    jnp.complexfloating):
            # round-3 carry format (v3): EvolveCarry gained a trailing scalar
            # (refactor_psi, 0 = no pending host refactorization). Only a
            # pre-v3 file resumes by defaulting it — a v3 file missing its
            # last leaf is truncated/corrupt and still fails loudly below.
            legacy_pad = True
        elif len(idxs) != len(t_leaves):
            raise ValueError(
                f"checkpoint has {len(idxs)} leaves, template expects "
                f"{len(t_leaves)} — config/shape mismatch")
        out = []
        for i, want in enumerate(t_leaves):
            want_dtype = jnp.asarray(want).dtype if not hasattr(want, "dtype") \
                else want.dtype
            want_shape = _leaf_shape(want)
            if legacy_pad and i == len(t_leaves) - 1:
                out.append(jnp.zeros((), want_dtype))
                continue
            tag = f"leaf_{i:04d}"
            if jnp.issubdtype(want_dtype, jnp.complexfloating):
                if f"{tag}_re" in files:
                    re, im = data[f"{tag}_re"], data[f"{tag}_im"]
                    got = re.astype(np.complex128) + 1j * im.astype(np.complex128)
                    got_dtype = np.complex64 if re.dtype == np.float32 \
                        else np.complex128
                elif tag in files and version == 1:   # legacy CPU-written file
                    got = data[tag]
                    got_dtype = got.dtype
                else:
                    raise ValueError(f"leaf {i}: template is complex "
                                     f"({want_dtype}) but checkpoint has no "
                                     f"re/im planes for it")
                if np.dtype(got_dtype) != np.dtype(want_dtype):
                    raise ValueError(
                        f"leaf {i}: checkpoint dtype {got_dtype} != template "
                        f"{want_dtype} — refusing to cast silently (was the "
                        f"checkpoint written under a different precision "
                        f"config?)")
                if got.shape != want_shape:
                    raise ValueError(f"leaf {i}: checkpoint shape {got.shape} "
                                     f"!= template {want_shape}")
                out.append(_restore_leaf(got, want, want_dtype, True))
            else:
                if tag not in files:
                    raise ValueError(f"leaf {i}: template is real "
                                     f"({want_dtype}) but checkpoint stores "
                                     f"complex planes for it")
                got = data[tag]
                if np.dtype(got.dtype) != np.dtype(want_dtype):
                    raise ValueError(
                        f"leaf {i}: checkpoint dtype {got.dtype} != template "
                        f"{want_dtype} — refusing to cast silently")
                if got.shape != want_shape:
                    raise ValueError(f"leaf {i}: checkpoint shape {got.shape} "
                                     f"!= template {want_shape}")
                out.append(_restore_leaf(got, want, want_dtype, False))
    return jax.tree.unflatten(treedef, out)
