"""``hapi.summary``, ``hapi.flops`` and ``Model.summary`` of the port
against the JAX package's, on the CPU, for LeNet and ResNet-50: the
returned parameter counts and FLOP totals, and every printed row (the
layer, its output shape and parameter count; the per-layer FLOPs),
exactly.  The JAX package runs its forward op by op, compiling each
primitive at each new shape, so ResNet-50 runs at 32 x 32.
"""
import io as _io
from contextlib import redirect_stdout

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch.convert import load_numpy_state


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _nets():
    jpaddle.seed(0)
    jnet = jpaddle.vision.models.LeNet()
    params, buffers = jnet.functional_state()
    pnet = load_numpy_state(paddle.vision.models.LeNet(device='cpu'),
                            {k: np.array(v) for k, v in params.items()},
                            {k: np.array(v) for k, v in buffers.items()})
    return jnet, pnet


def _printed(fn):
    buf = _io.StringIO()
    with redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def test_summary_and_flops_of_lenet_equal_the_reference():
    jnet, pnet = _nets()
    js, jtext = _printed(lambda: jpaddle.summary(jnet, (1, 1, 28, 28)))
    ps, ptext = _printed(lambda: paddle.summary(pnet, (1, 1, 28, 28)))
    assert ps == js and ptext == jtext
    jf, jrows = _printed(lambda: jpaddle.flops(jnet, [2, 1, 28, 28],
                                               print_detail=True))
    pf, prows = _printed(lambda: paddle.flops(pnet, [2, 1, 28, 28],
                                              print_detail=True))
    assert pf == jf and prows == jrows
    model = paddle.Model(pnet)
    assert _printed(lambda: model.summary((1, 1, 28, 28)))[0] == js


def test_summary_and_flops_of_resnet50_equal_the_reference():
    jpaddle.seed(0)
    jnet = jpaddle.vision.models.resnet50(num_classes=10)
    pnet = paddle.vision.models.resnet50(num_classes=10, device='cpu')
    shape = [1, 3, 32, 32]
    js, jtext = _printed(lambda: jpaddle.summary(jnet, tuple(shape)))
    ps, ptext = _printed(lambda: paddle.summary(pnet, tuple(shape)))
    assert ps == js and ptext == jtext
    jf, jrows = _printed(lambda: jpaddle.flops(jnet, shape,
                                               print_detail=True))
    pf, prows = _printed(lambda: paddle.flops(pnet, shape,
                                              print_detail=True))
    assert pf == jf and prows == jrows
