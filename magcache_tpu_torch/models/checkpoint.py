"""Published checkpoint files: reading, writing and the tree helpers of the
state-dict converters.

The counterparts of ``magcache_tpu.models.convert``'s ``load_safetensors_dir``
and ``_torch_load_flat``, without the ``safetensors`` package: a
``.safetensors`` file is an 8-byte little-endian header length, a JSON header
(each tensor's ``dtype``, ``shape`` and ``data_offsets``, and an optional
``__metadata__``), then the raw bytes, which ``read_safetensors`` maps with
``torch.frombuffer`` on a private mmap. BF16, F16 and F32 arrive as torch
tensors of their own dtype, with no f32 copies, and pages are read when a
tensor is used. ``save_safetensors`` writes the same format.

``load_safetensors_dir`` merges a directory's ``*.safetensors`` shards, or
falls back to torch ``.pth`` / ``.pt`` / ``.bin`` files (``torch.load`` with
``weights_only`` and ``mmap``), unwrapping ``state_dict`` and ``module``.
Among several torch files it keeps those whose names are not a Wan
directory's auxiliaries (``umt5``, ``_vae``, ``vae_``, ``clip``,
``tokenizer``), and a key found in two of them raises.

``lin``, ``stack`` and ``vec`` build the JAX package's parameter trees from a
state dict with torch leaves: ``lin`` gives ``{"w": [d_in, d_out], "b"}``
as transposed views, ``stack`` keeps depth-stacked leaves as per-block lists,
so that ``models/convert.py``'s ``*_params_from_numpy`` lay them out with no
copy beyond the cast to each tensor's dtype (JAX's dtype first, then the
port's, as converting the JAX tree does).
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Dict, Iterable, Optional

import torch

__all__ = ["read_safetensors", "save_safetensors", "torch_load_flat",
           "load_safetensors_dir", "safetensors_keys", "vec", "lin", "stack",
           "conv_as_linear", "cat_lin"]

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
              "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}

# a Wan ckpt_dir's encoder, VAE, CLIP and tokenizer files beside the DiT
AUX_NAMES = ("umt5", "_vae", "vae_", "clip", "tokenizer")


def _header(f, path: str, size: int):
    raw = f.read(8)
    if len(raw) < 8:
        raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw)
    if 8 + n > size:
        raise ValueError(f"{path}: header of {n} bytes past the end of a {size}-byte file")
    return json.loads(f.read(n)), 8 + n


def safetensors_keys(path: str) -> list:
    """The tensor names of a ``.safetensors`` file (its header only)."""
    with open(path, "rb") as f:
        header, _ = _header(f, path, os.fstat(f.fileno()).st_size)
    return [k for k in header if k != "__metadata__"]


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of one ``.safetensors`` file, mapped from the file (a
    private copy-on-write mmap) in their stored dtype. A truncated file, an
    unknown dtype or a tensor whose bytes do not match its shape raises."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        header, start = _header(f, path, size)
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not one of "
                             f"{sorted(_ST_DTYPES)}")
        dt = _ST_DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        lo, hi = info["data_offsets"]
        count = 1
        for s in shape:
            count *= s
        nbytes = count * torch.empty((), dtype=dt).element_size()
        if hi - lo != nbytes:
            raise ValueError(f"{path}: {name} {info['dtype']}{list(shape)} needs {nbytes} "
                             f"bytes, its offsets span {hi - lo}")
        if start + hi > size:
            raise ValueError(f"{path}: {name} ends at byte {start + hi} of a {size}-byte "
                             f"file (truncated)")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dt)
        else:
            out[name] = torch.frombuffer(mm, dtype=dt, count=count,
                                         offset=start + lo).view(shape)
    return out


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (moved to the CPU, each in its own dtype) as one
    ``.safetensors`` file, data 8-byte aligned; returns the bytes written."""
    header, offset = {}, 0
    items = [(k, v.detach().to("cpu").contiguous()) for k, v in tensors.items()]
    for k, v in items:
        n = v.numel() * v.element_size()
        header[k] = {"dtype": _ST_NAMES[v.dtype], "shape": list(v.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, v in items:
            if v.numel():
                f.write(v.reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + offset


def torch_load_flat(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.pth`` / ``.pt`` / ``.bin`` file's tensors, mapped where
    the file allows it, with ``{"state_dict": ...}`` and ``{"module": ...}``
    unwrapped (``Wan2.1_VAE.pth``, hyvideo's ``mp_rank_00_model_states.pt``);
    entries that are not tensors are dropped."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except RuntimeError:         # the legacy (non-zip) format cannot be mapped
        sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "module"):
        if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
    return {k: v.detach() for k, v in sd.items() if torch.is_tensor(v)}


def _weight_files(path: str) -> list:
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files and os.path.isfile(path):
        files = [path]
    if not files:
        files = sorted(f for pat in ("*.pth", "*.pt", "*.bin")
                       for f in glob.glob(os.path.join(path, pat)))
        if len(files) > 1:
            main = [f for f in files
                    if not any(a in os.path.basename(f).lower() for a in AUX_NAMES)]
            files = main or files
    if not files:
        raise FileNotFoundError(f"no safetensors or torch weights found under {path}")
    return files


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Published weights under ``path`` (a directory or one file) as one
    flat dict of CPU tensors in their stored dtypes: ``*.safetensors``
    shards merged, else the torch files (see the module docstring)."""
    sd: Dict[str, torch.Tensor] = {}
    for f in _weight_files(path):
        flat = read_safetensors(f) if f.endswith(".safetensors") else torch_load_flat(f)
        dup = sd.keys() & flat.keys()
        if dup:
            raise ValueError(
                f"duplicate keys across weight files under {path} (e.g. "
                f"{sorted(dup)[:3]}): pass the intended file directly instead of the "
                f"directory")
        sd.update(flat)
    return sd


# ---- the JAX trees, with torch leaves --------------------------------------

def _get(sd: Dict[str, torch.Tensor], key: str) -> torch.Tensor:
    if key not in sd:
        raise KeyError(f"checkpoint has no {key!r}")
    return sd[key]


_EXACT_IN_F32 = (torch.float32, torch.bfloat16, torch.float16)


def vec(sd: Dict[str, torch.Tensor], key: str, dtype=torch.float32) -> torch.Tensor:
    """A tensor of the checkpoint as the JAX converter's ``jnp.asarray(
    sd[key], dtype)``. Where ``dtype`` is f32 and the stored dtype converts
    to it exactly, the tensor stays as stored (no host copy): its later cast
    to the port's dtype rounds as the cast from f32 would."""
    t = _get(sd, key)
    if t.dtype == dtype or (dtype == torch.float32 and t.dtype in _EXACT_IN_F32):
        return t
    return t.to(dtype)


def lin(sd: Dict[str, torch.Tensor], name: str, dtype) -> dict:
    """``nn.Linear`` ``name`` as JAX's ``{"w": [d_in, d_out], "b"}`` in
    ``dtype`` (the bias where the checkpoint has one)."""
    p = {"w": vec(sd, f"{name}.weight", dtype).T}
    if f"{name}.bias" in sd:
        p["b"] = vec(sd, f"{name}.bias", dtype)
    return p


def stack(parts: Iterable[dict]) -> dict:
    """Per-block ``{key: leaf}`` dicts as one ``{key: [leaf per block]}``
    (JAX's depth-stacked leaves, indexable by block); nested dicts too."""
    parts = list(parts)
    return {k: (stack([p[k] for p in parts]) if isinstance(parts[0][k], dict)
                else [p[k] for p in parts]) for k in parts[0]}


def conv_as_linear(sd: Dict[str, torch.Tensor], name: str, dtype) -> dict:
    """A patchify conv ``[d, C, (kt,) kh, kw]`` as a linear over features
    flattened in ``(c, (pt,) ph, pw)`` order: ``{"w": [C*k..., d], "b"}``."""
    w = vec(sd, f"{name}.weight", dtype)
    return {"w": w.reshape(w.shape[0], -1).T, "b": vec(sd, f"{name}.bias", dtype)}


def cat_lin(sd: Dict[str, torch.Tensor], names, dtype) -> dict:
    """Several ``nn.Linear``s of one input concatenated on the output axis
    (fused q/k/v), biases where the first has one."""
    p = {"w": torch.cat([vec(sd, f"{n}.weight", dtype) for n in names], 0).T}
    if f"{names[0]}.bias" in sd:
        p["b"] = torch.cat([vec(sd, f"{n}.bias", dtype) for n in names])
    return p
