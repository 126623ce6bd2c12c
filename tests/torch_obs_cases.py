"""The port's toy trainer of the telemetry tests (``test_torch_obs*.py``):
``tests/test_obs.py``'s adapter and shards, in torch.

Two leaves of 4 f32 params, ``a`` inside M and ``b`` outside it; each
client's loss pulls ``a`` toward its data and ``b`` toward twice its data,
so rounds cost next to nothing and a NaN shard trains a NaN client.  8
clients of 8 points (``n_simple`` 4), batch 4: two SGD steps a client.
"""

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.federated import FederatedTrainer

FED = dict(n_devices=8, n_simple=4, participation=1.0, local_epochs=1,
           lr=0.1, batch_size=4, algorithm="fedhen", seed=0)


class ToyAdapter:
    """``tests/test_obs.py``'s ``_ToyAdapter`` on torch tensors."""

    def init(self, generator, device):
        return {"a": torch.zeros((4,), device=device),
                "b": torch.zeros((4,), device=device)}

    def subnet_mask(self, params):
        return {"a": torch.tensor(True), "b": torch.tensor(False)}

    @staticmethod
    def _loss(params, batch):
        x = batch["x"]
        err_a = params["a"][None] - x
        err_b = params["b"][None] - 2.0 * x
        return torch.mean(err_a ** 2) + torch.mean(err_b ** 2)

    loss_simple = loss_complex = loss_side = _loss

    def evaluate(self, params, batch):
        return {"acc_simple": params["a"].mean(),
                "acc_complex": params["b"].mean()}


def shards(n_devices=8, seed=0, poison=None):
    """Each client's ``(8, 4)`` f32 points (numpy), from ``seed``;
    ``poison``: the client whose first point gets a NaN."""
    rng = np.random.default_rng(seed)
    out = [{"x": rng.normal(size=(8, 4)).astype(np.float32)}
           for _ in range(n_devices)]
    if poison is not None:
        out[poison]["x"][0, 0] = np.nan
    return out


def eval_batch():
    return {"x": np.zeros((4, 4), np.float32)}


def make_trainer(telemetry=None, *, chunk=2, poison=None, n_devices=8,
                 schedule=None, bits=None, **fed_kw):
    """The toy trainer on the CPU (``fed_kw`` overrides :data:`FED`)."""
    cfg = dict(FED, n_devices=n_devices, n_simple=n_devices // 2,
               cohort_chunk=chunk)
    cfg.update(fed_kw)
    return FederatedTrainer(ToyAdapter(), FedConfig(**cfg),
                            shards(n_devices, poison=poison), device="cpu",
                            schedule=schedule, bits=bits,
                            telemetry=telemetry)
