"""Token serving in the port: the slot manager, the cache helpers, the
``Engine`` (greedy token lists equal to the reference ``Engine``'s at f32
compute, deterministic at bf16, seeded sampling) and ``launch.serve`` on
the host."""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_lm import configs, port_module, ref_params, spec_tree  # noqa: E402
from repro_torch.launch import serve as LAUNCH  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.serve import Engine, GenerationConfig  # noqa: E402
from repro_torch.serve.kv_cache import SlotManager, cache_bytes, zeros_like_shapes  # noqa: E402
from repro_torch.utils.tree import flatten_with_paths  # noqa: E402


def test_slot_manager():
    sm = SlotManager(2, 64)
    assert sm.admit(0, 8) == 0 and sm.admit(1, 8) == 1
    assert sm.admit(2, 8) is None  # full
    sm.record_token(0, 5, eos_id=5, max_new=10)
    assert sm.slots[0].done
    assert sm.admit(2, 8) == 0  # freed slot reused
    assert sm.positions().tolist() == [8, 8] and sm.active_mask().tolist() == [True, True]
    for _ in range(3):
        sm.record_token(1, 7, eos_id=-1, max_new=3)
    assert sm.slots[1].done and sm.slots[1].generated == [7, 7, 7]
    sm.record_token(1, 9, eos_id=-1, max_new=3)      # a done slot records nothing
    assert sm.slots[1].generated == [7, 7, 7]


@pytest.mark.parametrize("name", ("qwen3-0.6b", "jamba-1.5-large-398b", "whisper-tiny"))
def test_cache_helpers_match_reference(name):
    from repro.models.registry import Model as RModel
    from repro.serve.kv_cache import cache_bytes as ref_cache_bytes
    rcfg, cfg = configs(name)
    shapes, rshapes = Model(cfg).cache_shape(2, 24), RModel(rcfg).cache_shape(2, 24)
    assert cache_bytes(shapes) == ref_cache_bytes(rshapes)
    zeros = zeros_like_shapes(shapes, "cpu")
    assert spec_tree(rshapes) == {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                                  for p, t in flatten_with_paths(zeros)}
    assert all(not t.any() for _, t in flatten_with_paths(zeros))


def _prompts(vocab: int, n: int = 2, plen: int = 8, seed: int = 0):
    return np.random.default_rng(seed).integers(0, vocab, (n, plen)).astype(np.int32)


@pytest.mark.parametrize("name", ("qwen3-0.6b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"))
def test_engine_greedy_tokens_equal_reference_at_f32(name):
    from repro.serve.engine import Engine as RefEngine
    from repro.serve.engine import GenerationConfig as RefGen
    rm, rp = ref_params(name, "float32")
    model, module = port_module(name, "float32")
    prompts = _prompts(model.cfg.vocab, 3)
    want = RefEngine(rm, rp, batch_size=4, max_len=32).generate(
        prompts, RefGen(max_new_tokens=8))
    eng = Engine(model, module, batch_size=4, max_len=32, device="cpu")
    got = eng.generate(prompts, GenerationConfig(max_new_tokens=8))
    assert got == want and all(len(o) == 8 for o in got)
    assert eng.decode_bytes_per_token() == RefEngine(
        rm, rp, batch_size=4, max_len=32).decode_bytes_per_token()


def test_engine_runs_to_max_len_and_reuses_its_cache():
    from repro.serve.engine import Engine as RefEngine
    from repro.serve.engine import GenerationConfig as RefGen
    rm, rp = ref_params("mamba2-2.7b", "float32")
    model, module = port_module("mamba2-2.7b", "float32")
    prompts = _prompts(model.cfg.vocab, 2, plen=6, seed=4)
    want = RefEngine(rm, rp, batch_size=2, max_len=12).generate(prompts, RefGen(
        max_new_tokens=50))
    eng = Engine(model, module, batch_size=2, max_len=12, device="cpu")
    cache = eng.cache
    first = eng.generate(prompts, GenerationConfig(max_new_tokens=50))
    assert first == want and all(len(o) == 12 - 1 - 6 for o in first)
    eng.slots = SlotManager(2, 12)
    assert eng.generate(prompts, GenerationConfig(max_new_tokens=50)) == first
    assert eng.cache is cache


def test_engine_bf16_is_deterministic_across_engines():
    cfg = configs("qwen3-0.6b")[1]
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = _prompts(cfg.vocab)
    out1 = Engine(model, params, batch_size=2, max_len=48, device="cpu").generate(
        prompts, GenerationConfig(max_new_tokens=6))
    out2 = Engine(model, params.state_dict(), batch_size=2, max_len=48,
                  device="cpu").generate(prompts, GenerationConfig(max_new_tokens=6))
    assert out1 == out2 and all(len(o) == 6 for o in out1)


def test_engine_sampling_is_seeded():
    cfg = configs("qwen3-0.6b")[1]
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    prompts = _prompts(cfg.vocab)

    def run(seed):
        eng = Engine(model, params, batch_size=2, max_len=32, device="cpu")
        return eng.generate(prompts, GenerationConfig(max_new_tokens=10, temperature=2.0,
                                                      seed=seed))
    assert run(3) == run(3)
    assert run(3) != run(4)


def test_engine_eos_stops_a_request():
    cfg = configs("qwen3-0.6b")[1]
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = _prompts(cfg.vocab)
    free = Engine(model, params, batch_size=2, max_len=48, device="cpu").generate(
        prompts, GenerationConfig(max_new_tokens=6))
    eos = free[0][2]
    out = Engine(model, params, batch_size=2, max_len=48, device="cpu").generate(
        prompts, GenerationConfig(max_new_tokens=6, eos_id=eos))
    assert out[0] == free[0][:free[0].index(eos) + 1]


def test_engine_refuses_bad_input():
    cfg = configs("qwen3-0.6b")[1]
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(model, params, batch_size=2, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="3 prompts for 2 slots"):
        eng.generate(_prompts(cfg.vocab, 3))
    with pytest.raises(TypeError, match="nn.Module or its state dict"):
        Engine(model, [params], batch_size=2, max_len=16, device="cpu")


def test_entry_points_need_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs("qwen3-0.6b")[1]
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, params, batch_size=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LAUNCH.main(["--arch", "qwen3-0.6b", "--reduced", "--requests", "2"])


def test_launch_serve_runs_on_the_host(capsys):
    res = LAUNCH.main(["--arch", "qwen3-0.6b", "--reduced", "--requests", "3",
                       "--max-new", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [len(o) for o in res["outs"]] == [5, 5, 5]
    assert res["engine"].device == torch.device("cpu") and "tok/s on cpu" in out
    assert out.count("[serve] req") == 3
    for arch in ("whisper-tiny", "pixtral-12b"):
        with pytest.raises(SystemExit, match="token-input LM"):
            LAUNCH.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_launch_serve_tokens_equal_reference_launch():
    """The same seeded prompts through both launchers' engines, on the
    reference's parameters (f32 compute): equal token lists."""
    from repro.serve.engine import Engine as RefEngine
    from repro.serve.engine import GenerationConfig as RefGen
    rm, rp = ref_params("qwen3-0.6b", "float32")
    model, module = port_module("qwen3-0.6b", "float32")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, model.cfg.vocab, (4, 16)).astype(np.int32)
    want = RefEngine(rm, rp, batch_size=4, max_len=128).generate(prompts, RefGen(
        max_new_tokens=24))
    got = Engine(model, module, batch_size=4, max_len=128, device="cpu").generate(
        prompts, GenerationConfig(max_new_tokens=24))
    assert got == want
