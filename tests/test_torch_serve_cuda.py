"""The serving programs and engine on the card against themselves on the
CPU, on a tiny bf16 config (head dim 64, GQA 2:1, two layers). Every
test here needs a CUDA device and skips without one; the file imports
no JAX:

    python -m pytest --noconftest -q tests/test_torch_serve_cuda.py

The card's monolithic prefill attends through the flash kernel, the
CPU's through its plain version, and the card's matmuls round bf16 in
another order, so the pools are held within two bf16 ulps (atol 2^-5 on
values up to about 4, rtol 2^-6): one for the write's own rounding, one
for the layer input the attention moved. The lm head is scaled up, so
the logits' top-2 gaps stand far above that rounding and the tokens
must be equal.
"""

import dataclasses

import pytest
import torch

import horovod_tpu_torch.ops.flash_attention as tfa
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.serve import ServeConfig, ServeEngine, make_serve_fns
from horovod_tpu_torch.serve.speculative import DraftConfig

pytestmark = pytest.mark.cuda

CFG = ttr.TransformerConfig(vocab_size=512, d_model=128, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=256, max_seq=256,
                            dtype=torch.bfloat16, remat=False)
BS, W = 8, 6
KW = dict(max_batch=4, block_size=BS, max_prompt=40, max_new_tokens=8)


@pytest.fixture()
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _params(device):
    p = ttr.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    p["lm_head"] = p["lm_head"] * 16       # wide top-2 gaps
    return ttr.map_params(lambda t: t.to(device), p)


def test_programs_on_the_card_match_the_cpu(cuda_device):
    g = torch.Generator().manual_seed(1)
    shape = (CFG.n_layers, 20, BS, CFG.n_kv_heads, CFG.head_dim)
    k0 = torch.randn(shape, generator=g).to(torch.bfloat16)
    v0 = torch.randn(shape, generator=g).to(torch.bfloat16)
    toks = torch.randint(1, CFG.vocab_size, (40,), generator=g)
    pages = torch.randn((CFG.n_layers, 3) + shape[2:],
                        generator=g).to(torch.bfloat16)
    table = torch.tensor([3, 7, 1, 12, 0, 0], dtype=torch.int32)
    tables = torch.tensor([[3, 7, 1, 12, 0, 0], [2, 4, 5, 6, 8, 9],
                           [0] * W, [10, 11, 13, 14, 15, 16]],
                          dtype=torch.int32)
    calls = (
        ("prefill", (toks[:24], 21, table), CFG.n_layers),
        ("prefill_resume", (toks[:16], 16, 13, table), 0),
        ("decode", (toks[:4], torch.tensor([29, 47, 0, 50]), tables), 0),
        ("verify", (toks[:12].reshape(4, 3),
                    torch.tensor([20, 46, 0, 3]), tables), 0),
        ("inject", (torch.tensor([17, 18, 0]), pages, pages), 0),
    )
    out = {}
    for device in ("cpu", cuda_device):
        params = _params(device)
        fns = make_serve_fns(CFG, block_size=BS, table_width=W,
                             device=device)._asdict()
        res = []
        for name, args, want_launches in calls:
            kc, vc = k0.clone().to(device), v0.clone().to(device)
            before = tfa.flash_fwd_cuda.launches
            if name == "inject":
                r = fns[name](kc, vc, *args)
                tok = None
            else:
                r = fns[name](params, kc, vc, *args)
                tok = r[2].cpu()
            assert r[0] is kc and r[1] is vc          # in place
            got = tfa.flash_fwd_cuda.launches - before
            assert got == (want_launches if device != "cpu" else 0), name
            res.append((kc.float().cpu(), vc.float().cpu(), tok))
        out[str(device)] = res
    for (name, _, _), cpu, card in zip(calls, out["cpu"], out["cuda"]):
        # Block 0 is the null block: rows routed there may collide, and
        # whichever lands is never read.
        for a, b in zip(card[:2], cpu[:2]):
            torch.testing.assert_close(a[:, 1:], b[:, 1:], atol=2.0 ** -5,
                                       rtol=2.0 ** -6,
                                       msg=lambda m: f"{name}: {m}")
        if cpu[2] is not None:
            assert torch.equal(card[2], cpu[2]), name


def test_engine_streams_on_the_card_match_the_cpu(cuda_device):
    trace = [(list(range(5 + i, 5 + i + n)), m) for i, (n, m) in
             enumerate(((9, 8), (33, 5), (17, 8), (4, 3), (40, 6)))]
    streams = {}
    for device in ("cpu", cuda_device):
        params = _params(device)
        for label, kw in (("continuous", {}), ("chunked",
                                               {"prefill_chunk": 16}),
                          ("spec", {"draft": DraftConfig(
                              dataclasses.replace(CFG, n_layers=1)),
                              "spec_k": 3})):
            eng = ServeEngine(CFG, params, ServeConfig(**KW, **kw),
                              device=device)
            ptr = eng.cache.k.data_ptr()
            rids = [eng.submit(p, n) for p, n in trace]
            before = tfa.flash_fwd_cuda.launches
            eng.run_until_idle()
            launched = tfa.flash_fwd_cuda.launches - before
            assert eng.cache.k.data_ptr() == ptr
            assert eng.allocator.n_used == 0
            if device != "cpu":
                assert launched > 0 and launched % CFG.n_layers == 0
            streams[(str(device), label)] = [eng.result(r).tokens
                                             for r in rids]
    for label in ("continuous", "chunked"):
        assert streams[("cuda", label)] == streams[("cpu", label)]
    assert streams[("cuda", "spec")] == streams[("cuda", "continuous")]
