"""Secure (HE) matmul: both the weights and the activations are CKKS
ciphertexts and the server computes Y = X·W under encryption (paper §I) —
counterpart of ``repro/secure/secure_linear.py``.

* ``SecureMatmulEngine`` — block MM: an arbitrary (m × l)·(l × n) product
  cut into tiles of one ciphertext each (paper §VI-D), padded with zeros
  to tile multiples.  The batched path runs the whole tile grid through
  ``compile_blockmm`` (two slot-indexed HLT launches); the sequential path
  runs one unbatched Algorithm-2 program per (i, j, k) tile pair.
* ``SecureLinear`` — y = x @ W with W encrypted once at construction, or
  with ``chain=`` y = x·W·W2·…·Wk as one chain program with no decrypt
  between the hops.

The engine owns an ``HEContext`` (``core/compile.py``), on CUDA unless
``device="cpu"`` is asked for (or the mesh's device, with ``mesh=``).
The cost model picks the schedule; the ``schedule=`` knob is a
deprecated override, as in the reference.  ``mesh=``
(``launch/mesh.py``) makes ``schedule="sharded"`` multi-device: tiles
over the ``data`` ranks, limbs over the ``model`` ranks, the 2-D
parallel block MM; the cost model picks it where it is worth it.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np

from repro_torch.core.ckks import Ciphertext, CkksEngine, Keys
from repro_torch.core.compile import (HEContext, compile_blockmm,
                                      compile_hemm, compile_hemm_chain)
from repro_torch.core.costmodel import select_schedule
from repro_torch.core.hemm import (decrypt_matrix, encrypt_matrix, plan_hemm,
                                   plan_hemm_chain)
from repro_torch.core.params import HEParams
from repro_torch.launch.mesh import check_mesh


@dataclasses.dataclass
class SecureMatmulEngine:
    params: HEParams
    tile: int = 8                 # tile edge: 3·tile² ≤ 2·slots
    schedule: Optional[str] = None   # DEPRECATED: None = the cost model's
    rotation_chunk: Optional[int] = None
    batched: Optional[bool] = None   # default: batched iff fused schedule
    mesh: Optional[object] = None    # a launch.mesh.Mesh: "sharded" runs
    #   tiles over the data ranks and limbs over the model ranks
    ctx: Optional[HEContext] = None  # an externally owned context
    device: Optional[object] = None  # of the engine built when ctx is None

    def __post_init__(self):
        if self.ctx is None:
            device = self.device
            if check_mesh(self.mesh) is not None and device is None:
                device = self.mesh.device
            self.ctx = HEContext(CkksEngine(self.params, device=device),
                                 mesh=self.mesh)
        elif self.ctx.eng.params != self.params:
            raise ValueError("the injected HEContext was built for other "
                             "HE parameters")
        self.eng = self.ctx.eng
        if 3 * self.tile * self.tile > 2 * self.eng.params.slots:
            raise ValueError(f"tile {self.tile}: 3·tile² exceeds 2·slots = "
                             f"{2 * self.eng.params.slots}")
        self._plan = plan_hemm(self.eng, self.tile, self.tile, self.tile)
        if self.schedule is None:
            self.schedule = select_schedule(
                self.params, n_model=self.ctx.n_model, n_ct=self.ctx.n_ct,
                d=self._plan.ds_sigma.d, ctb=2 * self.tile)
        else:
            warnings.warn(
                "SecureMatmulEngine(schedule=...) is deprecated: leave it "
                "unset (the cost model selects the schedule) or compile "
                "programs explicitly via repro_torch.core.compile.",
                DeprecationWarning, stacklevel=3)
        if self.batched is None:
            self.batched = (self.schedule == "pallas"
                            or self.schedule.startswith("sharded"))

    def keygen(self, rng: np.random.Generator) -> Keys:
        return self.ctx.keygen(rng, rot_steps=self._plan.rot_steps)

    def encrypt_tiles(self, X: np.ndarray, rng) -> list:
        """Pad to tile multiples, encrypt each tile as one Ct (row-major
        grid)."""
        t = self.tile
        m, n = X.shape
        gm, gn = math.ceil(m / t), math.ceil(n / t)
        P = np.zeros((gm * t, gn * t))
        P[:m, :n] = X
        return [[encrypt_matrix(self.eng, self.ctx.keys,
                                P[i * t:(i + 1) * t, j * t:(j + 1) * t], rng)
                 for j in range(gn)] for i in range(gm)]

    def matmul_encrypted(self, A_tiles, B_tiles,
                         batched: Optional[bool] = None) -> list:
        """Block MM over ciphertext tiles: C[i][j] = Σ_k A[i][k]·B[k][j].

        ``batched=False``: the sequential loop, one unbatched Algorithm-2
        program per (i, j, k) tile pair.  ``batched=True``: the whole grid
        through ``compile_blockmm``."""
        if batched is None:
            batched = self.batched
        gm, gl, gn = len(A_tiles), len(A_tiles[0]), len(B_tiles[0])
        if len(B_tiles) != gl:
            raise ValueError(f"A has {gl} tile columns, B {len(B_tiles)} "
                             f"tile rows")
        if batched and self.schedule != "baseline":
            return self._matmul_encrypted_batched(A_tiles, B_tiles)
        prog = compile_hemm(self.ctx, self._plan, schedule=self.schedule,
                            rotation_chunk=self.rotation_chunk, batched=False)
        out = []
        for i in range(gm):
            row = []
            for j in range(gn):
                acc: Optional[Ciphertext] = None
                for k in range(gl):
                    prod = prog(A_tiles[i][k], B_tiles[k][j])
                    acc = prod if acc is None else self.eng.add(acc, prod)
                row.append(acc)
            out.append(row)
        return out

    def _matmul_encrypted_batched(self, A_tiles, B_tiles,
                                  a_slots=None, b_slots=None) -> list:
        """The whole grid as one ``compile_blockmm`` program; ``a_slots`` /
        ``b_slots`` are its row-major aliasing hints."""
        prog = compile_blockmm(
            self.ctx, self._plan,
            (len(A_tiles), len(B_tiles), len(B_tiles[0])),
            level=A_tiles[0][0].level, schedule=self.schedule,
            rotation_chunk=self.rotation_chunk,
            a_slots=a_slots, b_slots=b_slots)
        return prog(A_tiles, B_tiles)

    def decrypt_tiles(self, C_tiles, m: int, n: int) -> np.ndarray:
        t = self.tile
        gm, gn = len(C_tiles), len(C_tiles[0])
        out = np.zeros((gm * t, gn * t))
        for i in range(gm):
            for j in range(gn):
                out[i * t:(i + 1) * t, j * t:(j + 1) * t] = decrypt_matrix(
                    self.eng, self.ctx.keys, C_tiles[i][j], t, t)
        return out[:m, :n]

    def secure_matmul(self, A: np.ndarray, B: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
        """End to end: encrypt both inputs, block HE MM, decrypt."""
        if self.ctx.keys is None:
            self.keygen(rng)
        At = self.encrypt_tiles(A, rng)
        Bt = self.encrypt_tiles(B, rng)
        Ct = self.matmul_encrypted(At, Bt)
        return self.decrypt_tiles(Ct, A.shape[0], B.shape[1])


class SecureLinear:
    """y = x @ W with an encrypted path (both x and W encrypted, W once at
    construction) and a plaintext one (``secure=False``).

    Chain mode (``chain=(W2, …, Wk)``): y = x·W·W2·…·Wk as one compiled
    chain (``compile_hemm_chain``), an encrypted MLP block with no decrypt
    between the hops and every weight encrypted once at its hop's input
    level.  It runs x as one ciphertext (no tiles), so every hop's
    windows must fit the slots and the row count of x is fixed at
    construction (``chain_rows``).  The modulus chain must afford 3 levels
    a hop (``analysis.max_chain_depth``), else construction fails
    (``configs/fame_sets.py`` ``FAME_CHAIN_SETS`` are sized for it)."""

    def __init__(self, engine: SecureMatmulEngine, W: np.ndarray,
                 rng: np.random.Generator, chain=(),
                 chain_rows: Optional[int] = None):
        self.engine = engine
        self.W = np.asarray(W, dtype=np.float64)
        self.chain_weights = tuple(np.asarray(w, dtype=np.float64)
                                   for w in chain)
        self._chain_prog = None
        if self.chain_weights:
            if chain_rows is None:
                raise ValueError("chain= runs x as one ciphertext: pass "
                                 "chain_rows (the row count of x)")
            dims = (int(chain_rows), *self.W.shape,
                    *(w.shape[1] for w in self.chain_weights))
            self._chain = plan_hemm_chain(engine.eng, dims)
            # one keyset serves the engine's tile plan and the chain's hops
            steps = set(engine._plan.rot_steps) | set(self._chain.rot_steps)
            engine.ctx.keygen(rng, rot_steps=tuple(sorted(steps)))
            self._chain_prog = compile_hemm_chain(engine.ctx, self._chain)
            self._w_cts = self._chain_prog.encrypt_weights(
                (self.W, *self.chain_weights), rng)
            return
        if engine.ctx.keys is None:
            engine.keygen(rng)
        self._w_tiles = engine.encrypt_tiles(self.W, rng)

    def __call__(self, x: np.ndarray, rng, secure: bool = True) -> np.ndarray:
        if not secure:
            y = x @ self.W
            for w in self.chain_weights:
                y = y @ w
            return y
        if self._chain_prog is not None:
            eng, ctx = self.engine.eng, self.engine.ctx
            m, l = self._chain.dims[:2]
            if tuple(x.shape) != (m, l):
                raise ValueError(f"x of shape {x.shape}, the chain takes "
                                 f"{(m, l)}")
            ctY = self._chain_prog(encrypt_matrix(eng, ctx.keys, x, rng),
                                   self._w_cts)
            return decrypt_matrix(eng, ctx.keys, ctY, m, self._chain.dims[-1])
        xt = self.engine.encrypt_tiles(x, rng)
        ct = self.engine.matmul_encrypted(xt, self._w_tiles)
        return self.engine.decrypt_tiles(ct, x.shape[0], self.W.shape[1])
