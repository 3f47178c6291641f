"""HMM model core: the (pi, A, B) parameters as float32 log-space tensors.

Counterpart of ``cpgisland_tpu/models/hmm.py``.  The reference's plain-text
model dump (per state: one pi line, one transition row, one emission row;
CpGIslandFinder.java:207-224) is written and read byte for byte by
:func:`dump_text` / :func:`load_text`.
"""

from __future__ import annotations

import dataclasses
import math
from decimal import Decimal
from typing import IO, Union

import numpy as np
import torch

# log(0) stand-in. Finite so that (-inf) - (-inf) never produces NaNs in
# log-semiring arithmetic; exp(LOG_ZERO) underflows to exactly 0.0f.
LOG_ZERO = -1e30


def _log(p: torch.Tensor) -> torch.Tensor:
    return torch.where(p > 0, torch.log(torch.clamp_min(p, 1e-300)), LOG_ZERO)


@dataclasses.dataclass(frozen=True)
class HmmParams:
    """HMM parameters in log space, float32 tensors on one device.

    log_pi: [K]    initial state log-probabilities
    log_A:  [K, K] transition log-probabilities
    log_B:  [K, S] emission log-probabilities
    """

    log_pi: torch.Tensor
    log_A: torch.Tensor
    log_B: torch.Tensor

    @property
    def n_states(self) -> int:
        return self.log_pi.shape[-1]

    @property
    def n_symbols(self) -> int:
        return self.log_B.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.log_pi.device

    @property
    def pi(self) -> torch.Tensor:
        return torch.exp(self.log_pi)

    @property
    def A(self) -> torch.Tensor:
        return torch.exp(self.log_A)

    @property
    def B(self) -> torch.Tensor:
        return torch.exp(self.log_B)

    def to(self, device) -> "HmmParams":
        return HmmParams(
            log_pi=self.log_pi.to(device),
            log_A=self.log_A.to(device),
            log_B=self.log_B.to(device),
        )

    @classmethod
    def from_probs(cls, pi, A, B, device=None) -> "HmmParams":
        """Parameters from probabilities.  Tensors stay on their own device
        (the M-step builds the next model on the card with no host round
        trip) unless ``device`` is given; numpy arrays and lists go to
        ``device``, the CPU by default.  Either route rounds to float32 the
        same way, so the two give the same bits."""

        def as_f32(x):
            if isinstance(x, torch.Tensor):
                return x.to(device=device, dtype=torch.float32)
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=device or "cpu")

        pi, A, B = as_f32(pi), as_f32(A), as_f32(B)
        if A.shape != (pi.shape[0], pi.shape[0]) or B.shape[0] != pi.shape[0]:
            raise ValueError(
                f"inconsistent shapes pi={tuple(pi.shape)} A={tuple(A.shape)} "
                f"B={tuple(B.shape)}"
            )
        return cls(log_pi=_log(pi), log_A=_log(A), log_B=_log(B))

    def max_abs_diff(self, other: "HmmParams") -> torch.Tensor:
        """Max absolute difference in probability space — the convergence
        metric (the reference's driver stops when |model_t+1 - model_t| <
        epsilon, CpGIslandFinder.java:96,200-201).  A 0-d tensor on the
        parameters' device."""
        return torch.maximum(
            torch.max(torch.abs(self.pi - other.pi)),
            torch.maximum(
                torch.max(torch.abs(self.A - other.A)),
                torch.max(torch.abs(self.B - other.B)),
            ),
        )


def params_from_numpy(log_pi, log_A, log_B, device="cpu") -> HmmParams:
    """HmmParams from log-space arrays, bit for bit (float32).

    The bridge that carries a model across packages: the tests turn the JAX
    package's parameters into numpy arrays and feed both packages the same
    float32 values."""
    as_t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
    return HmmParams(log_pi=as_t(log_pi), log_A=as_t(log_A), log_B=as_t(log_B))


def java_double_str(d: float) -> str:
    """Format ``d`` exactly as Java ``Double.toString(double)`` would.

    Decimal form iff 1e-3 <= |d| < 1e7, otherwise ``d.dddE±x`` with an
    unpadded exponent and no '+'; a fraction part is always present.  Digits
    are the shortest sequence that round-trips (Python repr's contract)."""
    if math.isnan(d):
        return "NaN"
    if math.isinf(d):
        return "Infinity" if d > 0 else "-Infinity"
    sign = "-" if math.copysign(1.0, d) < 0 else ""
    if d == 0.0:
        return sign + "0.0"
    _, digits, exp = Decimal(repr(abs(d))).as_tuple()
    ds = "".join(map(str, digits)).rstrip("0") or "0"
    E = len(digits) + exp - 1  # value = ds[0].ds[1:] * 10**E
    if -3 <= E <= 6:
        if E < 0:
            return sign + "0." + "0" * (-E - 1) + ds
        ip = ds[: E + 1].ljust(E + 1, "0")
        return sign + ip + "." + (ds[E + 1 :] or "0")
    return sign + ds[0] + "." + (ds[1:] or "0") + "E" + str(E)


def dump_text(params: HmmParams, fp: Union[str, IO[str]]) -> None:
    """Write the reference's plain-text model dump (CpGIslandFinder.java:
    207-224): per state, pi(i); A[i, :] space-separated with a trailing
    space; B[i, :] likewise — numbers in Java ``Double.toString`` form."""
    own = isinstance(fp, str)
    f = open(fp, "w") if own else fp
    try:
        pi = params.pi.cpu().numpy().astype(np.float64)
        A = params.A.cpu().numpy().astype(np.float64)
        B = params.B.cpu().numpy().astype(np.float64)
        for i in range(params.n_states):
            f.write(java_double_str(float(pi[i])))
            f.write("\n")
            f.write("".join(java_double_str(float(v)) + " " for v in A[i]))
            f.write("\n")
            f.write("".join(java_double_str(float(v)) + " " for v in B[i]))
            f.write("\n")
    finally:
        if own:
            f.close()


def load_text(fp: Union[str, IO[str]], device="cpu") -> HmmParams:
    """Parse a model dump written by :func:`dump_text`."""
    own = isinstance(fp, str)
    f = open(fp) if own else fp
    try:
        lines = [ln.strip() for ln in f.read().splitlines() if ln.strip()]
    finally:
        if own:
            f.close()
    if len(lines) % 3 != 0:
        raise ValueError(f"model text has {len(lines)} non-empty lines, not a multiple of 3")
    k = len(lines) // 3
    pi = np.array([float(lines[3 * i]) for i in range(k)])
    A = np.array([[float(v) for v in lines[3 * i + 1].split()] for i in range(k)])
    B = np.array([[float(v) for v in lines[3 * i + 2].split()] for i in range(k)])
    return HmmParams.from_probs(pi, A, B, device=device)
