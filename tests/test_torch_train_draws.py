"""PyTorch port: where the CAE trainer's random draws come from.

JAX's `fit_cae` draws its init and augmentation from threefry keys, which
give the same numbers on every backend.  The port's `fit_cae` draws both
from one `torch.Generator` on the CPU seeded with `TrainConfig.seed` (the
init's draws first, then each step's `sample_params`), whatever the
device it trains on, and moves the parameters to the device
(`train.augment.warp_batch`).  A generator on the card would draw CUDA's
Philox stream, another init and other augmentations than the CPU's from
the same seed: on the card the train bench's `fit_cae` then stopped at
epoch 11 of 12 (`scripts/probe_cae_draws.py`).

- `fit_cae` hands `init_cae` and every `sample_params` call a CPU
  generator, and the init's is freshly seeded with the seed;
- on the CPU a run equals, bit for bit (history and weights), the run
  whose draws come from a generator on the data's device, the rule before
  the draws moved to the CPU: on the CPU nothing changed;
- the same holds on a mesh (`fit_cae(mesh=)`);
- `fit_cae` runs each epoch under cuDNN's deterministic algorithms and
  puts the caller's setting back;
- `warp_batch` takes the rotation's cosine and sine where the parameters
  lie (the CPU), before they cross to the batch's device;
- on a GPU (marker `cuda`), `fit_cae` on the card draws what it draws on
  the CPU: the same init and the same steps' parameters, bit for bit, and
  a batch warped on the card equals the CPU's bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.config import AugmentConfig, TrainConfig
from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
from cell_image_analysis_tpu_torch.train import augment, trainer
from cell_image_analysis_tpu_torch.utils.synthetic import make_cells

torch_threads()

_CFG = TrainConfig(epochs=2, batch_size=16)


def _cells(n: int = 96, seed: int = 5) -> torch.Tensor:
    return torch.as_tensor(make_cells(np.random.default_rng(seed), n))


class _Spy:
    """Records the generators (device, state when called) and the drawn
    parameters of `init_cae` and `sample_params` inside the trainer."""

    def __init__(self, monkeypatch):
        self.init, self.steps = [], []
        real_init, real_sample = trainer.init_cae, trainer.sample_params

        def init(generator, **kw):
            self.init.append((generator.device, generator.get_state()))
            model = real_init(generator, **kw)
            self.init_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            return model

        def sample(generator, n, cfg):
            p = real_sample(generator, n, cfg)
            self.steps.append((generator.device, [t.cpu().clone() for t in p]))
            return p

        monkeypatch.setattr(trainer, "init_cae", init)
        monkeypatch.setattr(trainer, "sample_params", sample)


def _replay_on(device, monkeypatch):
    """The trainer's draws from one generator on `device`, seeded with the
    seed, whatever generator `fit_cae` makes itself."""
    gen = torch.Generator(device=device).manual_seed(_CFG.seed)
    real_init, real_sample = trainer.init_cae, trainer.sample_params
    monkeypatch.setattr(trainer, "init_cae", lambda generator, **kw: real_init(gen, **kw))
    monkeypatch.setattr(trainer, "sample_params",
                        lambda generator, n, cfg: real_sample(gen, n, cfg))


def _same_run(a, b) -> None:
    (_, sa, ha), (_, sb, hb) = a, b
    assert ha.history == hb.history
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_fit_cae_draws_from_a_cpu_generator_seeded_with_the_seed(monkeypatch):
    spy = _Spy(monkeypatch)
    trainer.fit_cae(_cells(), train_cfg=_CFG, verbose=False)
    fresh = torch.Generator().manual_seed(_CFG.seed).get_state()
    assert len(spy.init) == 1
    device, state = spy.init[0]
    assert device == torch.device("cpu")
    assert torch.equal(state, fresh)
    steps = (96 - 20) // 16 * _CFG.epochs   # 76 train cells (sklearn's split), batch 16
    assert len(spy.steps) == steps
    assert all(d == torch.device("cpu") for d, _ in spy.steps)
    # the steps continue the init's stream
    gen = torch.Generator().manual_seed(_CFG.seed)
    trainer.init_cae(gen)
    for _, params in spy.steps[:3]:
        want = augment.sample_params(gen, 16, AugmentConfig())
        assert all(torch.equal(a, b) for a, b in zip(params, want))


def test_fit_cae_on_the_cpu_equals_the_data_device_rule_bit_for_bit(monkeypatch):
    cells = _cells()
    now = trainer.fit_cae(cells, train_cfg=_CFG, verbose=False)
    _replay_on(cells.device, monkeypatch)
    before = trainer.fit_cae(cells, train_cfg=_CFG, verbose=False)
    _same_run(now, before)


def test_fit_cae_on_a_cpu_mesh_equals_the_data_device_rule_bit_for_bit(monkeypatch):
    cells, mesh = _cells(), virtual_mesh("cpu", 2)
    now = trainer.fit_cae(cells, train_cfg=_CFG, verbose=False, mesh=mesh)
    _replay_on("cpu", monkeypatch)
    before = trainer.fit_cae(cells, train_cfg=_CFG, verbose=False, mesh=mesh)
    _same_run(now, before)


def test_warp_takes_its_trigonometry_where_the_params_lie(monkeypatch):
    seen = []
    real_cos, real_sin = torch.cos, torch.sin
    monkeypatch.setattr(torch, "cos", lambda t: seen.append(t.device) or real_cos(t))
    monkeypatch.setattr(torch, "sin", lambda t: seen.append(t.device) or real_sin(t))
    p = augment.sample_params(torch.Generator().manual_seed(3), 4, AugmentConfig())
    out = augment.warp_batch(torch.zeros((4, 16, 16, 1), device="meta"), p)
    assert seen == [torch.device("cpu")] * 2
    assert out.shape == (4, 16, 16, 1) and out.device.type == "meta"


def test_fit_cae_runs_its_epochs_cudnn_deterministic(monkeypatch):
    seen = []
    real = trainer._epoch

    def epoch(*a):
        seen.append(torch.backends.cudnn.deterministic)
        return real(*a)

    monkeypatch.setattr(trainer, "_epoch", epoch)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    trainer.fit_cae(_cells(48), train_cfg=_CFG, verbose=False)
    assert seen == [True] * _CFG.epochs
    assert torch.backends.cudnn.deterministic is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's draws against the CPU's")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_fit_cae_on_the_card_draws_what_the_cpu_draws(card, monkeypatch):
    cells = _cells()
    spy = _Spy(monkeypatch)
    cfg = TrainConfig(epochs=1, batch_size=16)
    trainer.fit_cae(cells.to(card), train_cfg=cfg, verbose=False)
    on_card = (spy.init_state, spy.steps[:])
    spy.steps.clear()
    trainer.fit_cae(cells, train_cfg=cfg, verbose=False)
    for k, v in on_card[0].items():
        assert torch.equal(v, spy.init_state[k]), k
    assert len(on_card[1]) == len(spy.steps)
    for (_, a), (_, b) in zip(on_card[1], spy.steps):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    params = spy.steps[0][1]
    x = cells[:16, ..., None]
    assert torch.equal(augment.warp_batch(x.to(card), params).cpu(),
                       augment.warp_batch(x, params))
