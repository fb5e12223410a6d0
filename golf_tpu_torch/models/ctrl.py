"""The ctrl protocol (counterpart of ``golf_tpu.models.ctrl``).

Every DSP module declares how many encoder channels it needs
(``split_sizes``) and how to map raw logits to constrained DSP parameters
(``ctrl``). A composite synth folds these over its controllable children in
order; the encoder's one linear head of width ``sum(sizes)`` is sliced into
the named groups.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from torch import nn

from ..core.sig import Sig


class Controllable(nn.Module):
    """Base for modules that consume encoder parameter groups."""

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return ()

    def ctrl(self, *logits: Sig) -> Tuple[Sig, ...]:
        return ()


class Synth(nn.Module):
    """Composite synthesizer base; ``ctrl_names`` lists the controllable
    children in order."""

    ctrl_names: Tuple[str, ...] = ()

    def _ctrl_children(self) -> List[Tuple[str, Controllable]]:
        return [(n, getattr(self, n)) for n in self.ctrl_names
                if isinstance(getattr(self, n, None), Controllable)]

    @property
    def param_layout(self) -> Tuple[Tuple[Tuple[int, ...], ...],
                                    Tuple[str, ...]]:
        children = self._ctrl_children()
        return (tuple(c.split_sizes for _, c in children),
                tuple(n + "_params" for n, _ in children))

    def apply_ctrl(self, raw: Dict[str, Tuple[Sig, ...]]
                   ) -> Dict[str, Tuple[Sig, ...]]:
        out = dict(raw)
        for name, child in self._ctrl_children():
            key = name + "_params"
            out[key] = child.ctrl(*raw.get(key, ()))
        return out


def split_heads(h: Sig, layout: Sequence[Sequence[int]],
                keys: Sequence[str]) -> Dict[str, Tuple[Sig, ...]]:
    """Slice a (B, T, sum(sizes)) head output into named raw groups;
    width-1 groups are squeezed to (B, T)."""
    flat = [s for group in layout for s in group]
    if h.shape[-1] != sum(flat):
        raise ValueError(f"head width {h.shape[-1]} != {sum(flat)}")
    pieces = []
    ofs = 0
    for s in flat:
        piece = h.data[..., ofs:ofs + s]
        pieces.append(Sig(piece[..., 0] if s == 1 else piece, h.hop))
        ofs += s
    out: Dict[str, Tuple[Sig, ...]] = {}
    i = 0
    for key, group in zip(keys, layout):
        out[key] = tuple(pieces[i:i + len(group)])
        i += len(group)
    return out
