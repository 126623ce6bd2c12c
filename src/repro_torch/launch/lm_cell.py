"""The full-width LM round cell: federated training of Gemma-2 2B.

Gemma-2 2B at full width (bf16, 2,614,224,384 params, n_flat above
2**31), 8 clients (4 simple, 4 complex) at participation 0.25 (one of each
a round), cohort_chunk 1, one local epoch of batch 2 over 4 sequences of
512 tokens a client (2 SGD steps), lr 0.1, the f32 wire, weights drawn on
the card from seed 0.  ``synthetic_lm``'s chain runs over the first 4,096
token ids (its transition table is vocab x vocab f32), and the test batch
is 4 sequences.  ``chip_smoke.py``'s phase 9 and ``profile_round.py``'s
LM column both build the cell from here.

The arch and the sequence length are parameters: xlstm-1.3b's round
(``chip_smoke.py`` phase 16) runs the same settings on sequences of
:data:`XLSTM_SEQ` = 1024 model inputs, the published ``mlstm_chunk``,
which must divide them; musicgen-large's (phase 17) on sequences of
:data:`SEQ` frames of its 4 codebooks.  A sequence of ``seq`` inputs is
``seq + 1`` tokens (``synthetic_lm``'s rows; the labels are the inputs
shifted).  The data take the arch's codebooks and draw from its first
``min(DATA_VOCAB, vocab_size)`` ids (musicgen-large has 2,048 a codebook).
"""

from __future__ import annotations

import torch

from repro_torch import configs
from repro_torch.configs.base import FedConfig
from repro_torch.core.adapters import LMAdapter
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data.federated import iid_split
from repro_torch.data.synthetic import synthetic_lm

ARCH = "gemma2-2b"
FED = dict(n_devices=8, n_simple=4, participation=0.25, cohort_chunk=1,
           local_epochs=1, batch_size=2, lr=0.1)
SEQ, PER_CLIENT, DATA_VOCAB, TEST = 512, 4, 4096, 4
XLSTM_SEQ = 1024


def _data(n: int, seq, seed: int, arch) -> dict:
    cfg = configs.get_config(arch or ARCH)
    return synthetic_lm(n, seq or SEQ, min(DATA_VOCAB, cfg.vocab_size),
                        seed=seed, n_codebooks=cfg.n_codebooks)


def shards(device="cuda", seq=None, arch=None) -> list:
    """Each client's token sequences (``seq`` model inputs each, the
    module's :data:`SEQ` by default) for ``arch`` (:data:`ARCH` by
    default), on ``device``."""
    data = _data(FED["n_devices"] * PER_CLIENT, seq, 0, arch)
    return [{"tokens": torch.as_tensor(s["tokens"]).to(device)}
            for s in iid_split(data, FED["n_devices"], seed=1)]


def test_batch(seq=None, arch=None) -> dict:
    return {"tokens": _data(TEST, seq, 999, arch)["tokens"]}


def trainer(client_shards: list, algorithm: str = "fedhen",
            device="cuda", telemetry=None, arch=None,
            **extra) -> FederatedTrainer:
    """The cell's trainer for ``algorithm`` on ``arch`` (the module's
    :data:`ARCH` by default) (``extra``: further ``FedConfig`` fields,
    e.g. the tree engine; ``telemetry``: the trainer's event registry)."""
    return FederatedTrainer(
        LMAdapter(configs.get_config(arch or ARCH)),
        FedConfig(algorithm=algorithm, **FED, **extra), client_shards,
        device=device, generator=torch.Generator(device).manual_seed(0),
        telemetry=telemetry)
