"""Inference API (counterpart of ``paddle_tpu/inference``; Paddle's
paddle.inference).

A ``jit.save`` artifact (the ``torch.export`` archive and its state)
reloads as a ``jit.TranslatedLayer``, which runs on the card as one
CUDA graph per input signature and launches the hand-written kernels
the exported graph names.  ``Config``/``Predictor``/``PredictorTensor``
mirror the reference's surface so deployment scripts port directly.
The Predictor runs on the card (``enable_use_gpu(device_id=)`` picks
one); ``Config.disable_gpu()`` is how a caller asks for the CPU, where
the plain twins run.  Importing this module does not import the
model's class: the artifact is all a server needs.
"""
import numpy as np
import torch

__all__ = ['Config', 'create_predictor', 'Predictor', 'PredictorTensor']


class Config:
    def __init__(self, prog_file=None, params_file=None):
        # jit.save writes one prefix; either arg may carry it
        self.model_path = prog_file
        self.device = None          # the card, unless asked otherwise
        self._memory_optim = True
        self._glog_info = False

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self.device = torch.device('cuda', int(device_id))

    def disable_gpu(self):
        self.device = torch.device('cpu')

    def enable_memory_optim(self):
        self._memory_optim = True

    def disable_glog_info(self):
        self._glog_info = False

    def switch_ir_optim(self, flag=True):
        pass

    def model_dir(self):
        return self.model_path


class PredictorTensor:
    """Input/output handle (reference: paddle_infer::Tensor).  An input
    holds the host array it was fed; an output holds the device tensor
    ``run()`` made, and ``copy_to_cpu()`` brings it to the host."""

    def __init__(self, name):
        self.name = name
        self._data = None

    def copy_from_cpu(self, arr):
        self._data = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        if isinstance(self._data, torch.Tensor):
            return self._data.detach().cpu().numpy()
        return np.asarray(self._data)

    def reshape(self, shape):
        if self._data is not None:
            self._data = self._data.reshape(shape)


class Predictor:
    def __init__(self, config):
        from .. import jit as _jit
        self._fn = _jit.load(config.model_path, device=config.device)
        self._inputs = {}
        self._outputs = []

    def get_input_names(self):
        """Real tensor names from the saved InputSpecs (reference
        deployments feed by name); positional input_i only when the
        artifact has no names."""
        got = self._fn.input_names()
        return got or ['input_0']

    def get_input_handle(self, name):
        h = self._inputs.get(name)
        if h is None:
            h = self._inputs[name] = PredictorTensor(name)
        return h

    def run(self):
        names = self.get_input_names()
        missing = [n for n in names if n not in self._inputs]
        if missing:
            raise KeyError(
                f'inputs {missing} were not fed — call '
                f'get_input_handle(name).copy_from_cpu(...) for each of '
                f'{names} before run()')
        args = [self._inputs[n]._data for n in names]
        out = self._fn(*args)
        if not isinstance(out, (tuple, list)):
            out = [out]
        self._outputs = []
        for i, o in enumerate(out):
            t = PredictorTensor(f'output_{i}')
            t._data = o
            self._outputs.append(t)
        return True

    def get_output_names(self):
        return [t.name for t in self._outputs]

    def get_output_handle(self, name):
        for t in self._outputs:
            if t.name == name:
                return t
        raise KeyError(name)


def create_predictor(config):
    return Predictor(config)
