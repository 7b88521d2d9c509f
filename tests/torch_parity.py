"""Shared helpers for the tests that hold ``unipose_tpu_torch`` against
``unipose_tpu``: the parity measure, seeded BN perturbation of JAX
variables, a JAX UniPose whose backbone depth can be cut, the same cut
for the JAX UniPoseLSTM, a fixture that pins torch's CPU threads, and the
launchers of data-parallel ranks as child processes."""

from __future__ import annotations

import base64
import contextlib
import functools
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from unipose_tpu.models.decoder import Decoder
from unipose_tpu.models.resnet import ResNet101
from unipose_tpu.models.wasp import WASP
from unipose_tpu.ops.resize import bilinear_resize


def max_rel_err(ours, ref) -> float:
    """max|a - b| over max|b|: the full-network parity measure of
    tests/test_parity_full.py:68-75 (randomised BN blows activations up, so
    elementwise rtol near zero crossings only measures f32 noise)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def rel_l2(ours, ref) -> float:
    """||a - b|| / ||b||: JAX's measure for the int8 forwards' drift
    (tests/test_quant.py:138-141)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


def codes_equal_but_ties(got, want, w, scale) -> None:
    """int8 codes equal, except where w / scale sits within 1e-4 of a
    rounding tie (there the two frameworks' last-ulp scales may round
    apart, by one code)."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    ratio = np.asarray(w, np.float64) / np.asarray(scale, np.float64)
    tie = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) < 1e-4
    assert np.abs(got - want).max() <= 1
    assert not ((got != want) & ~tie).any()


def perturb_bn(variables, seed: int):
    """Seeded random BN affine parameters and running statistics, as
    tests/test_parity_full.py:47-61 draws them, so eval-mode BN is a real
    transform.  Returns a new numpy tree."""
    rng = np.random.RandomState(seed)
    variables = jax.device_get(variables)

    def walk(params, stats):
        params, stats = dict(params), dict(stats)
        for k, v in stats.items():
            if isinstance(v, dict) and "running_mean" in v:
                c = v["running_mean"].shape
                stats[k] = {
                    "running_mean": (0.1 * rng.randn(*c)).astype(np.float32),
                    "running_var": (0.8 + 0.4 * rng.rand(*c)).astype(np.float32),
                }
                params[k] = {
                    "weight": (1.0 + 0.1 * rng.randn(*c)).astype(np.float32),
                    "bias": (0.05 * rng.randn(*c)).astype(np.float32),
                }
            elif isinstance(v, dict):
                params[k], stats[k] = walk(params[k], v)
        return params, stats

    params, stats = walk(variables["params"], variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


class ComposedUniPose(nn.Module):
    """``unipose_tpu.models.unipose.UniPose`` composed from its parts under
    the same names, with the backbone depth (and ``bn_groups``) as fields."""

    layers: Tuple[int, int, int, int] = (1, 1, 1, 1)
    num_classes: int = 14
    output_stride: int = 16
    stride: int = 8
    bbox_head: bool = False
    freeze_bn: bool = False
    bn_groups: int = 1

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        feats, low = ResNet101(
            output_stride=self.output_stride, layers=self.layers,
            freeze_bn=self.freeze_bn, bn_groups=self.bn_groups, name="backbone",
        )(x, train=train)
        y = WASP(output_stride=self.output_stride, freeze_bn=self.freeze_bn,
                 bn_groups=self.bn_groups, name="wasp")(feats, train=train)
        y = Decoder(
            self.num_classes, bbox_head=self.bbox_head, freeze_bn=self.freeze_bn,
            bn_groups=self.bn_groups, name="decoder",
        )(y, low, train=train)
        if self.stride != 8:
            y = bilinear_resize(y, x.shape[1:3])
        y = y.astype(jnp.float32)
        if self.bbox_head:
            k = self.num_classes + 1
            return y[..., :k], y[..., k:]
        return y


def init_composed(module: ComposedUniPose, seed: int, size: int = 64):
    """Variables of ``module`` (parameter shapes do not depend on ``size``),
    BN perturbed from ``seed``."""
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(seed), x
    )
    return perturb_bn(variables, seed + 1)


@contextlib.contextmanager
def reduced_lstm_depth(layers: Tuple[int, int, int, int]):
    """Inside the block, the JAX ``UniPoseLSTM`` builds its backbone with
    ``layers`` (the JAX model has no depth field; its parameter names do not
    change).  Every trace of the model, ``jit`` and ``apply``, must happen
    inside."""
    import pytest

    from unipose_tpu.models import unipose_lstm

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(unipose_lstm, "ResNet101", functools.partial(ResNet101, layers=layers))
        yield


@pytest.fixture(scope="module", autouse=True)
def two_threads_for_the_module():
    """``two_threads`` for a whole module, its module-scoped fixtures
    included: import it into a test module and it applies there."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def two_threads():
    """Torch on two CPU threads for the test: the test runner puts six
    workers on the machine, and a worker whose torch spins on every core
    slows them all (a full-depth CPU train step ran ~10x slower with four
    workers at eight threads each).  Import it into a test module and
    request it, or make it autouse there."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_variables(jax_model, state, *shapes, variant: str = "image"):
    """The JAX model's variables holding a port ``state_dict`` (numpy,
    reference keys), through the JAX package's own converter
    (``compat/torch_convert.py::convert_state_dict``).  The template comes
    from ``jax.eval_shape`` of the init on zero inputs of ``shapes``, so
    nothing is compiled (a jitted init of the full model takes ~20 s)."""
    from unipose_tpu.compat.torch_convert import convert_state_dict

    args = [jnp.zeros(s) for s in shapes]
    template = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), *args, train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    variables, report = convert_state_dict(state, template, variant=variant)
    assert all(k.endswith("num_batches_tracked") for k in report["skipped"]), report["skipped"]
    return jax.tree_util.tree_map(jnp.asarray, variables)


# ---------------------------------------------------------------------------
# Artifacts and their server (tests/test_torch_export_cli.py,
# tests/test_torch_serve_artifact_video.py)
# ---------------------------------------------------------------------------

SIZE = 64  # the artifacts' input side


def export_artifact(tmp_path_factory, name, *flags, layers=(1, 1, 1, 1)):
    """``cli/export.py`` on the CPU at SIZE x SIZE, with the backbone's depth
    cut to ``layers`` (``train/state.py``'s ``init_model`` patched); returns
    the artifact's path."""
    from unipose_tpu_torch.cli import export as export_cli
    from unipose_tpu_torch.models.unipose import init_model
    from unipose_tpu_torch.train import state as train_state

    path = tmp_path_factory.mktemp("artifacts") / name
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_state, "init_model", functools.partial(init_model, layers=layers))
        export_cli.main(["--out", str(path), "--size", str(SIZE), "--device", "cpu", *flags])
    return str(path)


def serve_args(artifact, **over):
    """Serve arguments with defaults; the geometry must come from the
    artifact (--size left wrong on purpose)."""
    from unipose_tpu_torch.cli import serve

    args = serve.parse_args(["--artifact", artifact, "--device", "cpu", "--port", "0", "--size", "368"])
    for k, v in over.items():
        setattr(args, k, v)
    return args


class _Server:
    """``cli/serve.make_server`` serving on a thread, and its HTTP calls."""

    def __init__(self, args):
        from unipose_tpu_torch.cli import serve

        self.srv = serve.make_server(args)
        self.service = self.srv.service
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def get(self, path="/healthz"):
        with urllib.request.urlopen(self.url + path, timeout=60) as r:
            return json.loads(r.read())

    def post(self, path, body):
        req = urllib.request.Request(self.url + path, data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=180) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


@pytest.fixture
def artifact_server():
    """start(args) -> a running ``_Server``; every one started is stopped at
    the test's end."""
    made = []

    def start(args):
        made.append(_Server(args))
        return made[-1]

    yield start
    for s in made:
        s.close()


def jpeg(seed, shape=(90, 120, 3)):
    import cv2

    img = np.random.RandomState(seed).randint(0, 255, shape, np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


def clip_body(seeds, shape=(80, 100, 3)):
    return json.dumps({"frames": [base64.b64encode(jpeg(s, shape)).decode() for s in seeds]}).encode()


def in_frame(kpts, w0, h0):
    return all(0 <= x <= w0 and 0 <= y <= h0 for x, y in kpts)


def post_concurrently(srv, path, bodies):
    results = [None] * len(bodies)

    def post(i):
        results[i] = srv.post(path, bodies[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    return results


# ---------------------------------------------------------------------------
# Ranks as child processes (tests/torch_ddp_worker.py): no process group,
# spawn or fork ever happens in the pytest process
# ---------------------------------------------------------------------------

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ddp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120  # seconds a child is waited on


def _child_env(**extra):
    """The environment of a rank: one OpenMP thread, no launcher variables
    inherited from the caller."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, **extra)
    return env


def _wait_all(procs, logs):
    """Wait on every child (``communicate(timeout=RANK_TIMEOUT)``); on a
    timeout kill them all, then fail with their output."""
    for p in procs:
        try:
            p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:  # each child's whole session: torchrun's ranks too
                if q.poll() is None:
                    os.killpg(q.pid, signal.SIGKILL)
            for q in procs:
                q.wait()
            pytest.fail("a rank timed out:\n" + "\n".join(_read(log) for log in logs))
    outs = [_read(log) for log in logs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, "a rank failed:\n" + "\n".join(outs)
    return outs


def _read(path) -> str:
    with open(path) as f:
        return f.read()[-20000:]


def run_ranks(mode: str, spec: dict, tmp_path, world: int = 2) -> list:
    """``torch_ddp_worker.py <mode>`` as ``world`` child processes meeting at
    a ``file://`` rendezvous under ``tmp_path`` (no port is picked, so test
    workers cannot collide); returns each rank's results."""
    spec = dict(spec, init=f"file://{tmp_path}/rdzv", out=str(tmp_path / mode))
    path = tmp_path / f"{mode}.json"
    path.write_text(json.dumps(spec))
    procs, logs = [], []
    for rank in range(world):
        logs.append(str(tmp_path / f"{mode}.rank{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, mode, str(path)], cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True,
                env=_child_env(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")))
    outs = _wait_all(procs, logs)
    for rank, out in enumerate(outs):
        assert f"RANK_OK {rank}" in out, out
    return [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in range(world)]


def run_torchrun(args, tmp_path, nproc: int = 2, tag: str = "torchrun") -> str:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc <args>`` as a child process; returns its output."""
    log = str(tmp_path / f"{tag}.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={nproc}", *args],
            cwd=REPO, stdout=f, stderr=subprocess.STDOUT, env=_child_env(), start_new_session=True)
    return _wait_all([proc], [log])[0]
