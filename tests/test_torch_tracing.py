"""The port's spans and counters (``utils/profiling.py``) on the CPU: nothing
recorded when off, nesting and keys, the span trees of a train epoch and of
a chunked request, the spans in ``trace()``'s Chrome file on the profiler's
clock, and the collectives' spans on a one-rank gloo group.

Nothing here imports JAX: the trainer and the pipeline are built from the
port's own modules at a tiny width.
"""

import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from simulgen_vae_tpu_torch.config import VAEConfig
from simulgen_vae_tpu_torch.data.scaler import MinMaxScaler
from simulgen_vae_tpu_torch.generate import make_generate_fn
from simulgen_vae_tpu_torch.models.conditioner_mlp import LatentConditioner
from simulgen_vae_tpu_torch.models.vae import VAE
from simulgen_vae_tpu_torch.ops import fused_adamw, gather_augment, groupnorm_gelu, quant
from simulgen_vae_tpu_torch.ops import readout_chain
from simulgen_vae_tpu_torch.parallel import collectives
from simulgen_vae_tpu_torch.train.vae_trainer import VAETrainer
from simulgen_vae_tpu_torch.utils import profiling
from simulgen_vae_tpu_torch.utils.profiling import recording, span, tick

T, NODE, INPUTS = 8, 64, 5
STEP_PHASES = ["train.assemble", "train.sn", "train.forward", "train.backward", "train.sn",
               "train.optimizer"]
CHUNK_PHASES = ["serve.conditioner", "serve.decode"]


def _cfg(**kw):
    base = dict(num_param=8, num_time=T, num_node=NODE, latent_dim_end=8, latent_dim=4,
                num_filter_enc=[16, 8, 8], small=True, n_epochs=4, batch_size=4, lr=1e-3)
    base.update(kw)
    return VAEConfig(**base)


def _data(n=8):
    g = torch.Generator().manual_seed(0)
    return (0.5 * torch.rand((n, T, NODE), generator=g) - 0.25).contiguous()


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s[3] == i]


def _names(spans, idx):
    return [spans[j][0] for j in idx]


def test_off_records_nothing():
    assert span("train.step") is span("serve.request")  # one shared no-op
    assert tick("train.steps") is None
    before = profiling.counters()["train.steps"]
    with span("outside"):
        with recording() as rec:
            pass
    assert rec.spans == [] and profiling.counters()["train.steps"] == before
    assert rec.counters["train.steps"] == 0 and rec.counters["serve.requests"] == 0


def test_nesting_parents_keys_and_threads():
    with recording() as rec:
        with span("a", key=7):
            with span("b"):
                with span("c", key=3):
                    time.sleep(0.002)
            with span("d"):
                pass
        with span("e"):
            pass
    names = [s[0] for s in rec.spans]
    assert names == ["a", "b", "c", "d", "e"]
    parents = [s[3] for s in rec.spans]
    assert parents == [-1, 0, 1, 0, -1]
    assert [s[4] for s in rec.spans] == [7, 7, 3, 7, None]
    assert len({s[5] for s in rec.spans}) == 1
    for name, start, end, parent, *_ in rec.spans:
        assert start <= end
        if parent >= 0:
            assert rec.spans[parent][1] <= start and end <= rec.spans[parent][2]
    assert rec.seconds("c") >= 0.002
    assert rec.seconds("c", within="a") == rec.seconds("c")
    assert rec.seconds("c", within="e") == 0.0
    with pytest.raises(RuntimeError, match="already recording"):
        with recording():
            with recording():
                pass


def test_launch_counters_are_one_merged_view():
    merged = profiling.counters()
    for mod in (groupnorm_gelu, gather_augment, fused_adamw, readout_chain, quant):
        assert set(mod.LAUNCHES) <= set(merged)
    with recording() as rec:
        gather_augment.LAUNCHES["gather_augment"] += 2
    gather_augment.LAUNCHES["gather_augment"] -= 2
    assert rec.counters["gather_augment"] == 2
    assert rec.counters["gn_act_onepass"] == 0


@pytest.mark.parametrize("cadence", ["step", "epoch"])
def test_train_epoch_span_tree(cadence):
    trainer = VAETrainer(_cfg(sn_cadence=cadence), device="cpu", seed=1)
    state = trainer.init_state(0)
    with recording() as rec:
        trainer.train_epoch(state, _data(), max_steps=2)
    spans = rec.spans
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert _names(spans, roots) == ["train.epoch"]
    kids = _children(spans, roots[0])
    want = ["train.step", "train.step"]
    phases = list(STEP_PHASES)
    if cadence == "epoch":  # the power iteration once; the rank-1 terms every step
        want = ["train.sn"] + want
        phases.remove("train.sn")
    assert _names(spans, kids) == want
    steps = [i for i in kids if spans[i][0] == "train.step"]
    keys = [spans[i][4] for i in steps]
    assert keys[1] == keys[0] + 1 and rec.counters["train.steps"] == 2
    for i in steps:
        inner = _children(spans, i)
        assert _names(spans, inner) == phases
        assert all(spans[j][4] == spans[i][4] for j in inner)
        forward = inner[phases.index("train.forward")]
        assert _names(spans, _children(spans, forward)) == ["decoder.readout"]


def test_streamed_epoch_span_tree():
    trainer = VAETrainer(_cfg(), device="cpu", seed=1)
    state = trainer.init_state(0)
    with recording() as rec:
        trainer.train_epoch_streaming(state, _data().numpy(), max_steps=2)
    spans = rec.spans
    root = [i for i, s in enumerate(spans) if s[3] == -1]
    assert _names(spans, root) == ["train.epoch"]
    kids = _children(spans, root[0])
    assert _names(spans, kids) == ["train.fetch", "train.step", "train.step"]
    first, second = (_names(spans, _children(spans, i)) for i in kids[1:])
    assert first == STEP_PHASES + ["train.fetch"] and second == STEP_PHASES


def _pipeline():
    cfg = _cfg()
    torch.manual_seed(0)
    vae = VAE(cfg.latent_dim_end, cfg.latent_dim, cfg.num_filter_dec, cfg.num_node,
              cfg.num_time, cfg.small, "cpu", torch.float32).eval()
    lc = LatentConditioner([16, 16], cfg.latent_dim_end, INPUTS, cfg.latent_dim,
                           cfg.num_hier, "cpu").eval()

    def scaler(n):
        return MinMaxScaler(torch.full((n,), 0.5), torch.zeros(n))

    return dict(cfg=cfg, lc_cfg=None, device=torch.device("cpu"), dtype=torch.float32,
                vae=vae, decoder_tree=None, lc=lc, lv_scaler=scaler(cfg.latent_dim_end),
                xs_scaler=scaler(cfg.latent_dim * cfg.num_hier), data_scaler=scaler(NODE))


def test_chunked_request_span_tree():
    fn = make_generate_fn(_pipeline(), descale_output=True, max_batch=2)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (3, INPUTS)).astype(np.float32)
    with recording() as rec:
        first = fn(x)
        fn(x)
    assert first.shape == (3, T, NODE)
    spans = rec.spans
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert _names(spans, roots) == ["serve.request", "serve.request"]
    assert spans[roots[1]][4] == spans[roots[0]][4] + 1 and rec.counters["serve.requests"] == 2
    kids = _children(spans, roots[0])
    # the tail chunk's padding is the one concat: each chunk writes its rows in place
    assert _names(spans, kids) == ["serve.chunk", "serve.concat", "serve.chunk"]
    for i in kids:
        assert spans[i][4] == spans[roots[0]][4]
        if spans[i][0] == "serve.chunk":
            inner = _children(spans, i)
            assert _names(spans, inner) == CHUNK_PHASES
            (readout,) = _children(spans, inner[1])
            assert _names(spans, [readout]) == ["decoder.readout"]
            # the descale runs inside the readout, in one pass with its GroupNorm
            assert _names(spans, _children(spans, readout)) == ["serve.descale"]


def test_trace_writes_the_spans_on_the_profilers_clock(tmp_path):
    """The spans land in the Chrome file as ``program`` events, and the
    operators the profiler records inside a span lie inside it on the
    trace's own clock (each side holds a millisecond of margin)."""
    x = torch.randn(128, 128)
    with profiling.trace(str(tmp_path)):
        with span("before"):
            time.sleep(0.001)
        with span("around", key=5):
            time.sleep(0.001)
            (x @ x).sum()
            time.sleep(0.001)
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    program = {e["name"]: e for e in events if e.get("cat") == "program"}
    assert set(program) == {"before", "around"}
    assert program["around"]["args"] == {"key": 5, "parent": -1}
    around, before = program["around"], program["before"]
    mms = [e for e in events if e.get("cat") == "cpu_op" and e.get("name") == "aten::mm"]
    assert mms
    for e in mms:
        assert around["ts"] <= e["ts"] and e["ts"] + e["dur"] <= around["ts"] + around["dur"]
        assert before["ts"] + before["dur"] <= e["ts"]


def test_collective_spans_on_a_one_rank_gloo_group(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        t = torch.ones(4)
        with recording() as rec:
            with span("train.step", key=0):
                collectives.all_reduce_(t, group)
                got = collectives.all_gather_cat(t, group, 0)
                collectives.broadcast_(t, group, 0)
            collectives.all_reduce_(t, None)  # no group: no call, no span
    finally:
        dist.destroy_process_group()
    assert got.shape == (4,) and torch.equal(t, torch.ones(4))
    assert [s[0] for s in rec.spans] == ["train.step", "collective.all_reduce",
                                         "collective.all_gather", "collective.broadcast"]
    assert all(s[3] == 0 and s[4] == 0 for s in rec.spans[1:])
    assert 0 < rec.seconds("collective.", within="train.step") <= rec.seconds("train.step")
    assert not hasattr(collectives, "STATS")
