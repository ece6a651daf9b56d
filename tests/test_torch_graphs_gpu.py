"""The port's CUDA graphs (``tortoise_tpu_torch/utils/graphs.py``) on the
GPU, case for case over both callers: DiffusionTts's forward at full width
(10 layers, 1024 channels, 16 heads; seeded random weights cast to bf16, as
served) and the hybrid prior's decode step (a period of its Mamba and
attention layers at the published widths). A replay equals the eager call
bit for bit, each signature captures once and every later call replays, a
returned tensor is the caller's, a capture is one span under the caller's
name, a replay counts its kernel launches, the calls that must stay eager
capture nothing, and a cast after a capture drops the graphs that read the
old weights.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a GPU and no jax (tests/conftest.py imports jax; skip it there):

    python3 -m pytest --noconftest -m gpu tests/test_torch_graphs_gpu.py

Without a CUDA device the cases skip.
"""
import pytest
import torch

from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, sample_speech
from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts, DiffusionTtsConfig
from tortoise_tpu_torch.models.granite_hybrid import GraniteVoice, GraniteVoiceConfig
from tortoise_tpu_torch.ops.attn import flash_rel_attention
from tortoise_tpu_torch.ops.ssm_step import ssm_decode_step
from tortoise_tpu_torch.utils import profiling
from tortoise_tpu_torch.weights import cast_for_inference, float32_device, init_random

pytestmark = pytest.mark.gpu
# the quality API's frames for 128 and 192 bucketed latents
BUCKETS = (557, 835)
# a period of both layer kinds at the published widths
SMALL = GraniteVoiceConfig(layers=4, attention_layers=(2,))


class Diffusion:
    """A diffusion sampling step's forward: noisy mel, timesteps, aligned
    embeddings, valid lengths (each row its own, some frames padding) and
    bias vectors; stateless, so the eager call may come after the graphed
    one."""
    kernel = flash_rel_attention
    per_call = 13
    span = "tts.diffusion.capture"
    signatures = [(b, t) for b in (1, 2) for t in BUCKETS]
    calls = 4

    def __init__(self, model):
        self.model = model

    @staticmethod
    def build(mixed: bool = False) -> DiffusionTts:
        """Served (bf16 weights), or ``mixed``: float32 weights computing in
        bf16, as trained."""
        with torch.device("cuda"):
            m = DiffusionTts(DiffusionTtsConfig(), dtype=torch.bfloat16 if mixed else None)
        init_random(m, 0)
        return (m if mixed else cast_for_inference(m, torch.bfloat16)).eval()

    def start(self, sig):
        self.b, self.t = sig
        self.biases = self.model.rel_bias_vectors(self.t)

    def span_attrs(self):
        return {"batch": self.b, "frames": self.t}

    def inputs(self, seed: int):
        g = torch.Generator(device="cuda").manual_seed(10 * self.t + seed)
        x = torch.randn((self.b, self.t, 100), generator=g, device="cuda")
        ts = torch.randint(0, 4000, (self.b,), generator=g, device="cuda")
        pre = torch.randn((self.b, self.t, 1024), generator=g, device="cuda") \
            .to(self.model.dtype)
        valid = torch.tensor([self.t - 40 - 61 * i for i in range(self.b)], device="cuda")
        return x, ts, pre, valid

    def run(self, inputs, biases: bool = True):
        x, ts, pre, valid = inputs
        return self.model(x, ts, pre, valid_len=valid, rel_biases=self.biases if biases else None,
                          flash=True)

    def call(self, seed: int):
        return self.run(self.inputs(seed))

    def eager(self, seed: int):
        x, ts, pre, valid = self.inputs(seed)
        return self.model._forward_eager(x, ts, pre, valid_len=valid, rel_biases=self.biases,
                                         flash=True)

    def serve(self) -> int:
        """A request's steps at one signature: the forward calls made."""
        self.start((2, BUCKETS[0]))
        for step in range(5):
            self.call(step)
        return 5

    def check_state(self):
        pass


class Granite:
    """The hybrid's decode step over a prefilled cache; the eager call runs
    on a copy of the cache, so it comes once after each graphed call."""
    kernel = ssm_decode_step
    per_call = len(SMALL.mamba_layers)
    span = "tts.ar.capture"
    # a new size drops the cache and its graph
    signatures = [(8,), (3,)]
    calls = 50

    def __init__(self, model):
        self.model = model

    @staticmethod
    def build(mixed: bool = False) -> GraniteVoice:
        """Served (bf16 weights), or ``mixed``: the MLPs' weights float32
        (the kernel needs the Mamba layers' in bf16)."""
        with torch.device("cuda"):
            m = GraniteVoice(SMALL)
        init_random(m, 3)
        m = cast_for_inference(m, torch.bfloat16).eval()
        if mixed:
            for layer in m.layers:
                for p in layer.shared_mlp.parameters():
                    p.data = p.data.float()
        return m

    def start(self, sig):
        (self.b,) = sig
        self.gen = torch.Generator(device="cuda").manual_seed(1)
        prompt = torch.randn((1, 30, SMALL.model_dim), generator=self.gen, device="cuda") \
            .to(torch.bfloat16) * 0.05
        self.cache = self.model.decode_cache(self.b, "cuda")
        self.model.prefill(prompt, self.cache)
        self.eager_cache = {k: v.clone() for k, v in self.cache.items()}

    def span_attrs(self):
        return {"rows": self.b}

    def inputs(self, seed: int):
        g = torch.Generator(device="cuda").manual_seed(100 + seed)
        return (torch.randn((self.b, SMALL.model_dim), generator=g, device="cuda") * 0.05) \
            .to(torch.bfloat16)

    def run(self, x):
        return self.model.decode_step(x, self.cache)

    def call(self, seed: int):
        return self.run(self.inputs(seed))

    def eager(self, seed: int):
        return self.model._decode_layers(self.inputs(seed), self.eager_cache)

    def serve(self) -> int:
        """A request's decode (``sample_speech``): the decode steps made."""
        cond = torch.randn((1, SMALL.model_dim), device="cuda").to(torch.bfloat16) * 0.1
        text = torch.tensor([[5, 6, 7, 8, 0, 0]], device="cuda")
        settings = SamplerSettings(max_generate=20, emit_latents=False)
        codes, _ = sample_speech(self.model, cond, text,
                                 torch.Generator(device="cuda").manual_seed(4), 4, settings)
        assert codes.shape == (4, settings.max_generate)
        return settings.max_generate - 1

    def check_state(self):
        for name in ("ssm", "conv", "k", "v", "pos"):
            assert torch.equal(self.cache[name], self.eager_cache[name]), name


CALLERS = {"diffusion": Diffusion, "granite": Granite}


@pytest.fixture(scope="module")
def diffusion_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the calls are captured as CUDA graphs")
    return Diffusion.build()


@pytest.fixture(params=list(CALLERS))
def caller(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the calls are captured as CUDA graphs")
    float32_device("cuda")
    if request.param == "diffusion":
        model = request.getfixturevalue("diffusion_model")
        model.graphs.clear()
        return Diffusion(model)
    return Granite(Granite.build())


def _counters(c):
    return c.model.graphs.captures, c.model.graphs.replays, c.kernel.launches


@torch.inference_mode()
def test_replay_equals_the_eager_call_bit_for_bit(caller):
    for sig in caller.signatures:
        caller.start(sig)
        captures, replays, _ = _counters(caller)
        for step in range(caller.calls):
            got = caller.call(step)
            want = caller.eager(step)
            assert torch.equal(got, want), (sig, step, (got - want).abs().max().item())
            # padded frames come out as the eager call leaves them
            assert torch.isfinite(got).all()
        caller.check_state()
        # a new signature captures anew; its later calls replay
        assert _counters(caller)[:2] == (captures + 1, replays + caller.calls - 1)


@torch.inference_mode()
def test_captured_once_then_replayed_every_later_call(caller):
    for round_ in range(2):
        captures, replays, launches = _counters(caller)
        calls = caller.serve()
        assert _counters(caller) == (captures + (round_ == 0),
                                     replays + calls - (round_ == 0),
                                     launches + calls * caller.per_call)


@torch.inference_mode()
def test_a_returned_output_is_not_overwritten_by_the_next_call(caller):
    caller.start(caller.signatures[-1])
    outs = []
    for step in range(3):
        out = caller.call(step)
        outs.append((out, out.clone()))
    for out, kept in outs:
        assert torch.equal(out, kept)
    assert not torch.equal(outs[1][0], outs[2][0])


@torch.inference_mode()
def test_a_capture_is_one_span_under_the_callers_name(caller):
    from torch.profiler import ProfilerActivity, profile

    caller.start(caller.signatures[-1])
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.spans().clear()
        for step in range(3):
            caller.call(step)
        spans = [s for s in profiling.spans() if s.name.endswith(".capture")]
    assert [(s.name, s.attrs) for s in spans] == [(caller.span, caller.span_attrs())]


@torch.inference_mode()
def test_a_replay_counts_its_kernel_launches(caller):
    caller.start(caller.signatures[-1])
    caller.call(0)
    for step in range(1, 4):
        captures, replays, launches = _counters(caller)
        caller.call(step)
        assert _counters(caller) == (captures, replays + 1, launches + caller.per_call)


@pytest.mark.parametrize("caller, case", [
    ("diffusion", "grad"), ("diffusion", "train"), ("diffusion", "capturing"),
    ("diffusion", "no_rel_biases"),
    ("granite", "grad"), ("granite", "train"), ("granite", "capturing")],
    indirect=["caller"])
def test_calls_that_stay_eager_capture_and_replay_nothing(caller, case):
    """Under grad, in train mode, inside another capture or (the diffusion)
    without bias vectors the call runs op by op: both graph counters stay,
    and its kernels count their calls."""
    with torch.no_grad():
        caller.start(caller.signatures[0])
        inputs = caller.inputs(0)
    captures, replays, launches = _counters(caller)
    try:
        if case == "train":
            caller.model.train()
        if case == "capturing":
            with torch.inference_mode():
                caller.call(1)      # the kernels' first calls come before the capture
                captures, replays, launches = _counters(caller)
                outer = torch.cuda.CUDAGraph()
                with torch.cuda.graph(outer, capture_error_mode="thread_local"):
                    out = caller.run(inputs)
        else:
            with torch.set_grad_enabled(case == "grad"):
                out = caller.run(inputs, biases=False) if case == "no_rel_biases" \
                    else caller.run(inputs)
    finally:
        caller.model.eval()
    assert out.shape[0] == caller.signatures[0][0]
    assert _counters(caller) == (captures, replays, launches + caller.per_call)


@torch.inference_mode()
def test_a_cast_after_capture_replays_the_cast_weights(caller):
    """A model captured with float32 weights and then cast by
    ``weights.cast_for_inference`` computes with the cast weights: the cast
    drops the graphs, whose float32 storage it freed (and which is then
    overwritten here), and the next call captures anew."""
    c = type(caller)(type(caller).build(mixed=True))
    del caller
    sig = c.signatures[-1]
    c.start(sig)
    for step in range(2):
        assert torch.equal(c.call(step), c.eager(step))
    freed = [p.numel() for p in c.model.parameters() if p.dtype == torch.float32]
    cast_for_inference(c.model, torch.bfloat16)
    garbage = [torch.full((n,), float("nan"), device="cuda") for n in freed]
    captures = c.model.graphs.captures
    c.start(sig)
    for step in range(2, 5):
        got = c.call(step)
        want = c.eager(step)
        assert torch.equal(got, want), (step, (got - want).abs().max().item())
    assert c.model.graphs.captures == captures + 1
    del garbage
