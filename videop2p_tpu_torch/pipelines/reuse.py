"""Cross-step deep-feature reuse schedules (port of
``videop2p_tpu/pipelines/reuse.py``, DeepCache-style).

Adjacent diffusion steps compute nearly identical deep UNet features (Ma et
al., 2023): on a "skip" step of the cached fast edit the deep down, mid and
up stages are skipped and the deep feature of the last full step, the input
of the final up block, is reused, so only the shallow path (conv_in → down
block 0 → final up block → output convolutions) runs
(``models/unet.py``'s ``deep_mode``).

Grammar of the ``reuse_schedule`` knob:
  * ``"off"``          — no reuse (the plain edit, bit for bit).
  * ``"uniform:K"``    — the full UNet every K-th step (positions 0, K,
    2K, …), shallow in between; skip fraction (K − 1)/K.
  * ``"custom:<p0,p1,...>"`` — explicit full-step positions: strictly
    increasing, starting at 0 (the first step must fill the cache), all
    inside ``[0, num_steps)``.

Stdlib only.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = [
    "REUSE_OFF",
    "parse_reuse_schedule",
    "validate_reuse_schedule",
    "reuse_skip_fraction",
    "reuse_label",
]

REUSE_OFF = "off"


def parse_reuse_schedule(schedule: Optional[str],
                         num_steps: int) -> Optional[Tuple[bool, ...]]:
    """A schedule string → per-step full-UNet flags (length ``num_steps``,
    ``True`` = run the full UNet, ``False`` = shallow reuse step), or None
    for "off". Raises ``ValueError`` on malformed schedules, mirroring
    ``pipelines.cached.validate_step_positions``'s contract: position 0
    must be a full step — there is no cached deep feature to reuse yet."""
    if schedule in (None, REUSE_OFF, ""):
        return None
    schedule = str(schedule)
    num_steps = int(num_steps)
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if schedule.startswith("uniform:"):
        try:
            k = int(schedule.split(":", 1)[1])
        except ValueError:
            raise ValueError(
                f"reuse_schedule={schedule!r}: uniform:K needs an integer K"
            ) from None
        if k < 1:
            raise ValueError(
                f"reuse_schedule={schedule!r}: K must be >= 1 "
                "(K=1 runs the full UNet every step)"
            )
        return tuple(i % k == 0 for i in range(num_steps))
    if schedule.startswith("custom:"):
        body = schedule.split(":", 1)[1]
        try:
            positions = tuple(int(p) for p in body.split(",") if p.strip())
        except ValueError:
            raise ValueError(
                f"reuse_schedule={schedule!r}: custom:<positions> needs a "
                "comma-separated integer list"
            ) from None
        if not positions:
            raise ValueError(
                f"reuse_schedule={schedule!r}: custom needs at least one "
                "full-step position"
            )
        if positions[0] != 0:
            raise ValueError(
                f"reuse_schedule={schedule!r}: positions must start at 0 — "
                "the first step has no cached deep feature to reuse"
            )
        if any(b <= a for a, b in zip(positions, positions[1:])):
            raise ValueError(
                f"reuse_schedule={schedule!r}: positions must be strictly "
                "increasing"
            )
        if positions[-1] >= num_steps:
            raise ValueError(
                f"reuse_schedule={schedule!r}: position {positions[-1]} is "
                f"outside [0, {num_steps}) for this step count"
            )
        full = [False] * num_steps
        for p in positions:
            full[p] = True
        return tuple(full)
    raise ValueError(
        f"reuse_schedule={schedule!r} is not 'off', 'uniform:K' or "
        "'custom:<p0,p1,...>'"
    )


def validate_reuse_schedule(schedule: Optional[str], num_steps: int) -> str:
    """Validate and normalize a schedule knob value (None/"" → "off");
    returns the canonical string (the CLI's fail-fast check)."""
    if schedule in (None, "", REUSE_OFF):
        return REUSE_OFF
    parse_reuse_schedule(schedule, num_steps)
    return str(schedule)


def reuse_skip_fraction(full_flags: Optional[Tuple[bool, ...]]) -> float:
    """Fraction of steps that run the shallow path (0.0 when off)."""
    if not full_flags:
        return 0.0
    return 1.0 - (sum(1 for f in full_flags if f) / float(len(full_flags)))


def reuse_label(schedule: Optional[str]) -> str:
    """A file-name-safe suffix token for a schedule
    (``uniform:2`` → ``uniform2``; off → "")."""
    if schedule in (None, "", REUSE_OFF):
        return ""
    return str(schedule).replace(":", "").replace(",", "_")
