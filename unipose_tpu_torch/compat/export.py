"""Serialized inference artifacts via ``torch.export``.

Counterpart of ``unipose_tpu/compat/export.py`` (StableHLO there): a
self-contained program of the eval forward, weights baked in, that the
server (``cli/serve.py --artifact``) loads and runs without the model code.
The JAX I/O contract holds exactly, NHWC on both sides:
  * image: (B, H, W, 3) uint8 (``raw_uint8``: (x - 128) / 256 baked in) or
    normalised f32 -> (B, H/8, W/8, K+1) f32;
  * video: (B, T, H, W, 3) and a (B, T, H, W, 1) f32 centermap ->
    (B, T, H/8, W/8, K+1) f32;
  * streaming video: a pair of chunk programs, ``init(frames, centermap)``
    and ``cont(frames, centermap, cell, hide)``, each -> (heat, cell, hide)
    with the f32 ConvLSTM state NHWC (B, H/8, W/8, K+2).
The NCHW / channels-last permutes happen inside the programs.

Each program is built by ``torch.export.export`` under ``torch.no_grad()``
at a static batch and clip length, from a frozen copy of the model
(:func:`freeze`): the folded stem and WASP weights, the ConvLSTM's joined
gates and, in bf16, the bf16 conv weights are computed once and held as
buffers, so a call folds and casts nothing and no weight cache (they key on
``data_ptr``, which a traced tensor does not have) runs in the trace.  The
kernels are the registered ops ``unipose::fused_stem``,
``unipose::wasp_cascade`` and ``unipose::conv_i8``: the program calls them,
and this module imports their registrations and nothing of ``models/``, so
an artifact loads without the model code.

An image or clip artifact is the bytes of ``torch.export.save`` (a zip,
with ``extra/unipose.json``: kind, device, dtype).  A streaming artifact
keeps the JAX container layout with the port's own magic: MAGIC + u64
init length + init bytes + u64 cont length + cont bytes.  The programs'
tensors live on the device they were exported on; loading onto another
device raises.
"""

from __future__ import annotations

import copy
import io
import json
import struct
import warnings
import zipfile
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

# the registered ops an exported program calls
from unipose_tpu_torch.ops.kernels import conv_i8, fused_stem, wasp_cascade  # noqa: F401

STREAM_MAGIC = b"UPTORCHSTREAM1"
JAX_STREAM_MAGIC = b"UPSTREAM1"  # unipose_tpu/compat/export.py's container
META = "unipose.json"
_ZIP = b"PK\x03\x04"
MEAN, STD = 128.0, 256.0  # train/steps.py::preprocess_images


# --------------------------------------------------------------------------
# The frozen eval program
# --------------------------------------------------------------------------


def freeze(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """An eval-only copy of ``module`` for export: every submodule with a
    ``freeze(dtype)`` method (the ResNet stem, WASP, the ConvLSTM cell)
    folds its weights into buffers once, then every remaining conv weight
    and bias is cast to ``dtype`` (BatchNorm stays f32, as in the live
    model).  ``module`` itself is left as it is."""
    frozen = copy.deepcopy(module).eval()
    for m in list(frozen.modules()):
        if hasattr(m, "freeze"):
            m.freeze(dtype)
    for m in frozen.modules():
        if isinstance(m, nn.Conv2d):
            m._cast = None  # models.layers.Conv2d's cache: unused once cast
            m.weight = nn.Parameter(m.weight.detach().to(dtype), requires_grad=False)
            if m.bias is not None:
                m.bias = nn.Parameter(m.bias.detach().to(dtype), requires_grad=False)
    return frozen.requires_grad_(False)


def _preprocess(x: torch.Tensor) -> torch.Tensor:
    return (x.float() - MEAN) / STD


class _ImageNet(nn.Module):
    """The image model in the JAX layout: (B, H, W, 3) normalised ->
    (B, H/8, W/8, K+1) f32."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _VideoNet(nn.Module):
    """The video model in the JAX layout: (B, T, H, W, 3) normalised frames
    and (B, T, H, W, 1) centermaps -> (B, T, H/8, W/8, K+1) f32; with
    ``stream``, also the final (cell, hide), NHWC, and optionally an initial
    state in the same layout."""

    def __init__(self, model: nn.Module, stream: bool = False):
        super().__init__()
        self.model, self.stream = model, stream

    def forward(self, frames, centermap, cell=None, hide=None):
        state = None if cell is None else (cell.permute(0, 3, 1, 2), hide.permute(0, 3, 1, 2))
        heat, (c, h) = self.model(
            frames.permute(0, 1, 4, 2, 3), centermap.permute(0, 1, 4, 2, 3), initial_state=state
        )
        heat = heat.permute(0, 1, 3, 4, 2)
        if not self.stream:
            return heat
        return heat, c.permute(0, 2, 3, 1), h.permute(0, 2, 3, 1)


class _Program(nn.Module):
    """``net`` behind the artifact's input dtype: uint8 pixels normalised
    inside (``raw_uint8``), or normalised f32."""

    def __init__(self, net: nn.Module, raw_uint8: bool):
        super().__init__()
        self.net, self.raw_uint8 = net, raw_uint8

    def forward(self, x, *rest):
        return self.net(_preprocess(x) if self.raw_uint8 else x, *rest)


def _example_inputs(program: nn.Module, shape, raw_uint8: bool, video: bool) -> Tuple[torch.Tensor, ...]:
    """Zero inputs of the artifact's static geometry, on the program's
    device: the frames or images, and for video the centermap."""
    device = next(t for t in (*program.parameters(), *program.buffers())).device
    x = torch.zeros(tuple(shape), dtype=torch.uint8 if raw_uint8 else torch.float32, device=device)
    if not video:
        return (x,)
    b, t, h, w, _ = shape
    return (x, torch.zeros((b, t, h, w, 1), device=device))


def _export(program: nn.Module, args: Tuple[torch.Tensor, ...]):
    with torch.no_grad():
        ep = torch.export.export(program, args)
    if hasattr(ep, "_example_inputs"):
        ep._example_inputs = None  # the artifact needs no sample batch
    return ep


def _serialize(ep, kind: str, device: torch.device, dtype: torch.dtype, raw_uint8: bool) -> bytes:
    """The program's bytes, with ``unipose.json`` (read by
    :func:`artifact_meta`)."""
    meta = {"kind": kind, "device": str(device), "dtype": str(dtype), "raw_uint8": raw_uint8}
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # The archive writer takes a channels-last conv weight (strides not
        # row-major) for a slice of a larger storage and warns; it is the
        # whole storage, and is written and read back as it is.
        warnings.filterwarnings("ignore", message="No complete tensor found in the group")
        torch.export.save(ep, buf, extra_files={META: json.dumps(meta)})
    return buf.getvalue()


def _write(blob: bytes, path: Optional[str]) -> bytes:
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_inference(
    model: nn.Module,
    input_shape: Sequence[int],
    *,
    path: Optional[str] = None,
    video: bool = False,
    forward: Optional[nn.Module] = None,
    raw_uint8: bool = False,
) -> bytes:
    """Export the eval-mode forward of ``model`` (a ``UniPose`` or
    ``UniPoseLSTM``, on the device the program is for) as artifact bytes.

    input_shape: (B, H, W, 3) image or (B, T, H, W, 3) video.  ``forward``
    replaces the model's forward (image: f(x); video: f(frames, centermap),
    normalised NHWC in, NHWC heatmaps out): the int8 front end
    (``models/quantized.py``).  ``raw_uint8``: the artifact takes raw uint8
    pixels and normalises them itself (4x less host-to-device traffic); a
    ``forward`` override still receives normalised f32.  Returns the bytes
    (also written to ``path`` when given)."""
    net = forward if forward is not None else (_VideoNet(model) if video else _ImageNet(model))
    dtype = getattr(forward if forward is not None else model, "compute_dtype")
    program = _Program(freeze(net, dtype), raw_uint8)
    args = _example_inputs(program, input_shape, raw_uint8, video)
    ep = _export(program, args)
    return _write(_serialize(ep, "video" if video else "image", args[0].device, dtype, raw_uint8), path)


def export_video_stream(
    model: nn.Module,
    chunk_shape: Sequence[int],
    *,
    path: Optional[str] = None,
    raw_uint8: bool = False,
) -> bytes:
    """Export the streaming chunk pair of a ``UniPoseLSTM``.

    chunk_shape: (B, T, H, W, 3), the fixed chunk geometry.
      init: (frames, centermap) -> (heat, cell, hide)   [frame 0 via ConvLSTM0]
      cont: (frames, centermap, cell, hide) -> (heat, cell, hide)
    Heat is (B, T, H/8, W/8, K+1); the state is the f32 (cell, hide) pair,
    NHWC (B, H/8, W/8, K+2), carried across chunks."""
    dtype = model.compute_dtype
    program = _Program(freeze(_VideoNet(model, stream=True), dtype), raw_uint8)
    clip = _example_inputs(program, chunk_shape, raw_uint8, video=True)
    device = clip[0].device
    init = _export(program, clip)
    state = tuple(torch.zeros(shape, dtype=dt, device=device) for shape, dt in output_specs(init)[1:])
    cont = _export(program, clip + state)
    blob = STREAM_MAGIC + b"".join(
        struct.pack("<Q", len(x)) + x
        for x in (_serialize(init, "stream_init", device, dtype, raw_uint8),
                  _serialize(cont, "stream_cont", device, dtype, raw_uint8))
    )
    return _write(blob, path)


# --------------------------------------------------------------------------
# Loading
# --------------------------------------------------------------------------


def is_stream_artifact(blob: bytes) -> bool:
    return blob.startswith(STREAM_MAGIC)


def _refuse_jax(blob: bytes) -> None:
    if blob.startswith(JAX_STREAM_MAGIC):
        raise ValueError(
            "this is a unipose_tpu (JAX, StableHLO) streaming artifact; the PyTorch server "
            "serves artifacts written by unipose_tpu_torch.cli.export"
        )


def artifact_meta(blob: bytes) -> dict:
    """The ``unipose.json`` that :func:`export_inference` wrote into a
    program's bytes (kind, device, dtype, raw_uint8); raises ValueError for
    bytes that are not a program of this package."""
    _refuse_jax(blob)
    try:
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            name = next(n for n in zf.namelist() if n.rsplit("/", 1)[-1] == META)
            return json.loads(zf.read(name))
    except (zipfile.BadZipFile, StopIteration) as e:
        what = "a zip" if blob.startswith(_ZIP) else f"{blob[:8]!r}..."
        raise ValueError(
            f"not a unipose_tpu_torch artifact ({what}; a StableHLO artifact of the JAX package?): "
            "export one with unipose_tpu_torch.cli.export"
        ) from e


def _load_program(blob: bytes, device=None):
    meta = artifact_meta(blob)
    home = torch.device(meta["device"])
    if device is not None and torch.device(device).type != home.type:
        raise ValueError(
            f"the artifact holds its weights on {home}, and a program runs where it was "
            f"exported: it cannot run on {torch.device(device)}; export it again with "
            f"--device {torch.device(device).type}"
        )
    if home.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the artifact was exported on {home}, and no CUDA device is available")
    with warnings.catch_warnings():
        # the reader makes tensors over the (read-only) bytes before moving
        # them to their device; a program never writes its weights
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        return torch.export.load(io.BytesIO(blob))


def load_video_stream(blob: bytes, device=None):
    """Deserialize a streaming container; returns the (init, cont)
    ``ExportedProgram``s."""
    _refuse_jax(blob)
    if not is_stream_artifact(blob):
        raise ValueError("not a unipose_tpu_torch streaming video artifact (bad magic)")
    off = len(STREAM_MAGIC)
    programs = []
    for _ in range(2):
        (n,) = struct.unpack_from("<Q", blob, off)
        off += 8
        programs.append(_load_program(blob[off : off + n], device))
        off += n
    return tuple(programs)


def load_exported(blob: bytes, device=None):
    """Deserialize an image or clip artifact; returns its
    ``ExportedProgram`` (``.module()`` to call; :func:`input_specs` and
    :func:`output_specs` read the exact geometry from it).  ``device``: where
    the caller means to run it; another device than the artifact's raises."""
    return _load_program(blob, device)


def load_inference(blob: bytes, device=None):
    """Deserialize an artifact; returns a callable."""
    return load_exported(blob, device).module()


def _val(node):
    return node.meta["val"]


def input_specs(ep) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each user input of an exported program, from its
    placeholders' traced values."""
    names = set(ep.graph_signature.user_inputs)
    return [(tuple(_val(n).shape), _val(n).dtype) for n in ep.graph.nodes
            if n.op == "placeholder" and n.name in names]


def output_specs(ep) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each output of an exported program."""
    out = next(n for n in ep.graph.nodes if n.op == "output")
    return [(tuple(_val(a).shape), _val(a).dtype) for a in out.args[0]]
