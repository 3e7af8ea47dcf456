"""The port stands alone and runs on the card unless told otherwise.

* ``mxnet_tpu_torch`` and every one of its modules (``gluon``,
  ``autograd``, ``contrib``, ``operator``, the recurrent stack and the
  data-IO modules among them), and
  ``chip_smoke``, import without pulling in ``jax`` or any of
  ``mxnet_tpu`` (checked in a fresh interpreter, since this test process
  has both loaded);
* the entry points default to the card: without a CUDA device they raise
  a typed error instead of running on the CPU;
* ``chip_smoke.py`` exits non-zero and prints no result without a card,
  and when it stands alone in a directory.
"""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch
from mxnet_tpu_torch.base import DeviceUnavailable, MXNetError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    names = ["mxnet_tpu_torch"]
    for info in pkgutil.walk_packages(mxnet_tpu_torch.__path__,
                                      "mxnet_tpu_torch."):
        names.append(info.name)
    return names


def test_every_port_module_is_listed():
    mods = _all_modules()
    for want in ("mxnet_tpu_torch.serving.decode",
                 "mxnet_tpu_torch.ops.kernels",
                 "mxnet_tpu_torch.models.transformer",
                 "mxnet_tpu_torch.analysis.costmodel",
                 "mxnet_tpu_torch.resilience.container",
                 "mxnet_tpu_torch.telemetry.memory",
                 "mxnet_tpu_torch.convert", "mxnet_tpu_torch.deploy",
                 "mxnet_tpu_torch.name", "mxnet_tpu_torch.executor",
                 "mxnet_tpu_torch.initializer",
                 "mxnet_tpu_torch.symbol.symbol",
                 "mxnet_tpu_torch.symbol.contrib",
                 "mxnet_tpu_torch.ops.registry",
                 "mxnet_tpu_torch.ops.shape_hints",
                 "mxnet_tpu_torch.ops.matrix",
                 "mxnet_tpu_torch.ops.broadcast_reduce",
                 "mxnet_tpu_torch.ops.nn",
                 "mxnet_tpu_torch.resilience.guards",
                 "mxnet_tpu_torch.parallel.mesh",
                 "mxnet_tpu_torch.parallel.trainer",
                 "mxnet_tpu_torch.parallel.placement",
                 "mxnet_tpu_torch.parallel.audit",
                 "mxnet_tpu_torch.sparse",
                 "mxnet_tpu_torch.sparse.kernels",
                 "mxnet_tpu_torch.sparse.embedding",
                 "mxnet_tpu_torch.sparse.step",
                 "mxnet_tpu_torch.context",
                 "mxnet_tpu_torch.ndarray",
                 "mxnet_tpu_torch.ndarray.ndarray",
                 "mxnet_tpu_torch.ndarray.sparse",
                 "mxnet_tpu_torch.ops.sparse_storage",
                 "mxnet_tpu_torch.ops.optimizer_ops",
                 "mxnet_tpu_torch.optimizer",
                 "mxnet_tpu_torch.kvstore",
                 "mxnet_tpu_torch.io",
                 "mxnet_tpu_torch.io.io",
                 "mxnet_tpu_torch.metric",
                 "mxnet_tpu_torch.model",
                 "mxnet_tpu_torch.module",
                 "mxnet_tpu_torch.module.executor_group",
                 "mxnet_tpu_torch.module.base_module",
                 "mxnet_tpu_torch.module.module",
                 "mxnet_tpu_torch.module.bucketing_module",
                 "mxnet_tpu_torch.module.sequential_module",
                 "mxnet_tpu_torch.module.python_module",
                 "mxnet_tpu_torch.executor_manager",
                 "mxnet_tpu_torch.attribute",
                 "mxnet_tpu_torch.rnn", "mxnet_tpu_torch.rnn.io",
                 "mxnet_tpu_torch.callback",
                 "mxnet_tpu_torch.rtc", "mxnet_tpu_torch.rng",
                 "mxnet_tpu_torch.random", "mxnet_tpu_torch.engine",
                 "mxnet_tpu_torch.ndarray.random",
                 "mxnet_tpu_torch.ndarray.serialization",
                 "mxnet_tpu_torch.ops.init_ops",
                 "mxnet_tpu_torch.ops.elemwise",
                 "mxnet_tpu_torch.ops.random_ops",
                 "mxnet_tpu_torch.autograd", "mxnet_tpu_torch.operator",
                 "mxnet_tpu_torch.test_utils", "mxnet_tpu_torch.contrib",
                 "mxnet_tpu_torch.contrib.autograd",
                 "mxnet_tpu_torch.ndarray.contrib",
                 "mxnet_tpu_torch.gluon", "mxnet_tpu_torch.gluon.block",
                 "mxnet_tpu_torch.gluon.trainer",
                 "mxnet_tpu_torch.gluon.nn.conv_layers",
                 "mxnet_tpu_torch.gluon.model_zoo.vision",
                 "mxnet_tpu_torch.gluon.contrib.nn",
                 "mxnet_tpu_torch.ops.rnn", "mxnet_tpu_torch.ops.linalg",
                 "mxnet_tpu_torch.ops.spatial", "mxnet_tpu_torch.ops.contrib",
                 "mxnet_tpu_torch.models.ssd",
                 "mxnet_tpu_torch.models.inception_v4",
                 "mxnet_tpu_torch.ndarray.linalg",
                 "mxnet_tpu_torch.symbol.linalg",
                 "mxnet_tpu_torch.symbol.random",
                 "mxnet_tpu_torch.rnn.rnn_cell", "mxnet_tpu_torch.rnn.rnn",
                 "mxnet_tpu_torch.gluon.rnn.rnn_cell",
                 "mxnet_tpu_torch.gluon.rnn.rnn_layer",
                 "mxnet_tpu_torch.gluon.contrib.rnn.conv_rnn_cell",
                 "mxnet_tpu_torch.recordio", "mxnet_tpu_torch.io.native",
                 "mxnet_tpu_torch.io.pinned", "mxnet_tpu_torch.image",
                 "mxnet_tpu_torch.image.image",
                 "mxnet_tpu_torch.image.record_iter",
                 "mxnet_tpu_torch.image.detection",
                 "mxnet_tpu_torch.gluon.data",
                 "mxnet_tpu_torch.gluon.data.dataset",
                 "mxnet_tpu_torch.gluon.data.sampler",
                 "mxnet_tpu_torch.gluon.data.dataloader",
                 "mxnet_tpu_torch.gluon.data.vision",
                 "mxnet_tpu_torch.gluon.data.vision.datasets",
                 "mxnet_tpu_torch.gluon.data.vision.transforms",
                 "mxnet_tpu_torch.gluon.contrib.data",
                 "mxnet_tpu_torch.gluon.contrib.data.sampler",
                 "mxnet_tpu_torch.contrib.text",
                 "mxnet_tpu_torch.contrib.text.utils",
                 "mxnet_tpu_torch.contrib.text.vocab",
                 "mxnet_tpu_torch.contrib.text.embedding"):
        assert want in mods


def test_port_imports_neither_jax_nor_the_jax_package():
    code = "\n".join([
        "import importlib, sys",
        "sys.path.insert(0, %r)" % ROOT,
        "for name in %r:" % (_all_modules(),),
        "    importlib.import_module(name)",
        "import chip_smoke",
        "sys.path.insert(0, %r)" % os.path.join(ROOT, "tests"),
        "import torch_cases",
        "import mxnet_tpu_torch as mx",
        "mods = (mx.nd, mx.random, mx.rtc, mx.engine, mx.nd.random,",
        "        mx.gluon, mx.autograd, mx.contrib, mx.operator,",
        "        mx.test_utils, mx.nd.contrib, mx.gluon.model_zoo,",
        "        mx.contrib.autograd, mx.image, mx.recordio,",
        "        mx.gluon.data, mx.gluon.data.vision.transforms,",
        "        mx.gluon.contrib.data, mx.contrib.text,",
        "        mx.io.ImageRecordIter, mx.image.ImageDetIter)",
        "assert len([n for n in dir(mx.nd) if not n.startswith('__')]) > 250",
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'jaxlib'"
        " or m.startswith('jaxlib.') or m == 'mxnet_tpu'"
        " or m.startswith('mxnet_tpu.'))",
        "print('LEAKED' if bad else 'CLEAN', bad)",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("CLEAN"), out.stdout


def test_port_sources_name_no_jax_import():
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT,
                                                      "mxnet_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            text = open(os.path.join(dirpath, f)).read()
            for line in text.splitlines():
                s = line.strip()
                assert not s.startswith(("import jax", "from jax",
                                         "import mxnet_tpu ",
                                         "from mxnet_tpu ",
                                         "from mxnet_tpu.")), (f, s)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card paths do not "
                    "apply")


def test_entry_points_default_to_the_card():
    _no_cuda()
    from mxnet_tpu_torch.models.transformer import get_decode_step
    from mxnet_tpu_torch.serving.decode import (DecodeConfig, DecodeProgram,
                                                init_decode_params)
    cfg = DecodeConfig(16, 1, 8, 2, 8, page_size=4, max_seqs=2)
    params = init_decode_params(cfg, seed=0)
    with pytest.raises(DeviceUnavailable):
        DecodeProgram(params, cfg)
    with pytest.raises(DeviceUnavailable):
        DecodeProgram(params, cfg, device=None)
    with pytest.raises(DeviceUnavailable):
        get_decode_step(params, vocab_size=16, seq_len=8, num_layers=1,
                        hidden=8, heads=2, page_size=4, max_seqs=2)
    with pytest.raises(MXNetError):
        DecodeProgram(params, cfg, device="cuda")
    # asked for explicitly, the CPU runs (the plain versions)
    prog = DecodeProgram(params, cfg, device="cpu")
    toks = np.zeros((2, prog.config.forward_len), np.int32)
    assert prog.forward(toks)[0].shape == (2, 1)
    # the training entry points: the mesh, and the trainer built on it
    from mxnet_tpu_torch.models.transformer import get_symbol
    from mxnet_tpu_torch.parallel import MeshSpec, ShardedTrainer, make_mesh
    net = get_symbol(vocab_size=16, seq_len=8, num_layers=1, hidden=8,
                     heads=2)
    with pytest.raises(DeviceUnavailable):
        make_mesh((1,), ("dp",))
    with pytest.raises(DeviceUnavailable):
        ShardedTrainer(net)
    with pytest.raises(DeviceUnavailable):
        ShardedTrainer(net, device="cuda")
    tr = ShardedTrainer(net, MeshSpec(make_mesh((1,), ("dp",),
                                                device="cpu")))
    params, _mom, _aux = tr.init_state({"data": (2, 8),
                                        "softmax_label": (2, 8)})
    assert all(p.device.type == "cpu" for p in params)
    # the recommender: its tables live on the mesh's device, and the MLP
    # helper defaults to the card as well
    from mxnet_tpu_torch.sparse import (ShardedEmbedding, init_mlp,
                                        recommender_state)
    with pytest.raises(DeviceUnavailable):
        init_mlp([4, 2, 1])
    spec = MeshSpec(make_mesh((1,), ("dp",), device="cpu"))
    embs = [ShardedEmbedding(10, 4, spec)]
    state = recommender_state(embs, dense_dim=2, hidden=(4,))
    assert state["tables"][0].device.type == "cpu"
    assert state["mlp"]["w0"].device.type == "cpu"
    # the Module path: the module, its store, the arrays and the context
    import mxnet_tpu_torch as mx
    with pytest.raises(DeviceUnavailable):
        mx.mod.Module(net)
    with pytest.raises(DeviceUnavailable):
        mx.kv.create("device")
    with pytest.raises(DeviceUnavailable):
        mx.nd.zeros((2, 3))
    with pytest.raises(DeviceUnavailable):
        mx.nd.array(np.zeros(3))
    with pytest.raises(DeviceUnavailable):
        mx.current_context()
    assert mx.mod.Module(net, context=mx.cpu()) is not None
    assert mx.kv.create("device", device="cpu").device.type == "cpu"
    with mx.cpu():
        assert mx.nd.zeros((2, 3)).context == mx.cpu()
    # the imperative API: creation, random draws and loads default to the
    # card too; CudaModule has no CPU path
    for call in (lambda: mx.nd.ones((2,)), lambda: mx.nd.random.normal(
            shape=(2,)), lambda: mx.nd.arange(3), lambda: mx.nd._zeros(
            shape=(2,)), lambda: mx.nd.load(os.devnull)):
        with pytest.raises(DeviceUnavailable):
            call()
    with pytest.raises(MXNetError):
        mx.rtc.CudaModule('extern "C" __global__ void k() {}')
    with mx.cpu():
        assert mx.nd.random.normal(shape=(2,)).context == mx.cpu()


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, timeout=180,
                          cwd=cwd)


def test_chip_smoke_fails_without_a_card():
    _no_cuda()
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
