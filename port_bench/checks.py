"""The comparison that decides ``correct``.

Each answer the timed path returned is judged against the plain reference
(``reference/codec.py``), computed again from the same inputs in float64:

* an encode answer (a container) is read back by the reference's own
  parser and entropy decoder, and its levels are compared with the f64
  levels of the frame it was made from;
* a decode answer (an image) is compared with the f64 decode of the
  container it was made from.

A level or pixel counts as bad where it differs from the reference and
either the f64 value is not within the f32 error bound of a .5 tie, or it
differs by more than 1 (the tie contract).  A container that does not
parse, or an image of the wrong shape, counts every one of its levels or
pixels as bad.  An input that got no answer counts as missing.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference import codec as R

#: The limit of each number compared, and the readings it was set from
#: (PERF.md, "How correct is decided").  Both are counts that the tie
#: contract holds at 0.
LIMITS = {"bad_levels": 0, "bad_pixels": 0, "missing": 0}


class Reference:
    """The reference's expected answer for each input of the pool."""

    def __init__(self, codec: R.Codec, kind: str, pool: List, device):
        self.codec, self.kind, self.pool = codec, kind, pool
        self.device = torch.device(device)
        self._expected = {}

    @property
    def number(self) -> str:
        return "bad_levels" if self.kind == "frames" else "bad_pixels"

    def expected(self, i: int):
        if i not in self._expected:
            item = self.pool[i]
            if self.kind == "frames":
                frame = torch.from_numpy(np.ascontiguousarray(item))
                self._expected[i] = R.encode_levels(self.codec,
                                                    frame.to(self.device))
            else:
                levels = R.decode_container_levels(self.codec, item,
                                                   self.device)
                self._expected[i] = R.decode_planes(self.codec, levels)
        return self._expected[i]

    def bad(self, i: int, answer) -> int:
        """Bad levels or pixels of one answer to pool input ``i``."""
        want, ties = self.expected(i)
        if self.kind == "frames":
            try:
                got = R.decode_container_levels(self.codec, bytes(answer),
                                                self.device)
            except R.StreamError:
                return want.numel()
        else:
            got = as_planes(answer, self.device)
            if got is None or got.shape != want.shape:
                return want.numel()
        diff = got.to(torch.int64) - want.to(torch.int64)
        bad = (diff != 0) & (~ties | (diff.abs() > 1))
        return int(bad.sum())


def as_planes(answer, device):
    """An image answer as (3, H, W) on ``device``: a host (H, W, 3) array
    or a (3, H, W) device tensor."""
    if isinstance(answer, torch.Tensor):
        return answer.to(device) if answer.dim() == 3 else None
    a = np.asarray(answer)
    if a.ndim != 3:
        return None
    return torch.from_numpy(np.ascontiguousarray(a)).to(device).permute(2, 0, 1)


def judge(reference: Reference, samples: Dict[int, List], missing: int):
    """{number: {"value", "limit"}} over the sampled answers."""
    bad = sum(reference.bad(i, a) for i, answers in samples.items()
              for a in answers)
    return {reference.number: {"value": bad, "limit": LIMITS[reference.number]},
            "missing": {"value": missing, "limit": LIMITS["missing"]}}


def passed(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def control_answer(codec: R.Codec, kind: str, item, device):
    """The control: the reference computed in TF32 in the program's place,
    as the answer the program would give for ``item``."""
    dev = torch.device(device)
    if kind == "frames":
        frame = torch.from_numpy(np.ascontiguousarray(item)).to(dev)
        levels, _ = R.encode_levels(codec, frame, "tf32")
        return R.pack_container(codec, [R.entropy_encode(b) for b in levels])
    levels = R.decode_container_levels(codec, item, dev)
    planes, _ = R.decode_planes(codec, levels, "tf32")
    return planes.permute(1, 2, 0).cpu().numpy()
