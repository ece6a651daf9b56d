"""Model operations of a request, counted from the shapes, for ``mfu``.

Each function counts the multiply-adds of the products and convolutions of
one stage, twice (one multiply and one add), as ``FlopCounterMode`` counts
them; norms, activations and the sampler's arithmetic are left out. A
stage is counted as its inputs need it: the prompt once for all candidates,
causal attention over the keys a query sees, a row's valid frames. Left
out (under 1% of a request): the diffusion decoder's conditioning paths.
"""
from __future__ import annotations


def gpt(layers: int, c: int, b: int, new: int, ctx: int = 0, causal: bool = True) -> float:
    """A GPT-2 stack over ``new`` tokens after ``ctx`` cached ones, batch
    ``b``: the 12 c^2 of the denses a token, and each query's scores and
    weighted sum over the keys it sees (all ``ctx + new`` keys when not
    ``causal``)."""
    keys = new * ctx + (new * (new + 1) // 2 if causal else new * new)
    return layers * (2 * b * new * 12 * c * c + 4 * b * keys * c)


def attention_block(c: int, t: int, b: int = 1) -> float:
    """arch_util.AttentionBlock over t frames: qkv, the output dense, t x t
    scores and weighted sum."""
    return b * (2 * t * 4 * c * c + 4 * t * t * c)


def conditioning_encoder(c: int, frames: int, clips: int, blocks: int = 6) -> float:
    return clips * (2 * frames * 80 * c + blocks * attention_block(c, frames))


def clvp(dim: int, depth_text: int, depth_speech: int, text: int, speech: int,
         candidates: int, ff_mult: int = 2) -> float:
    """CLVP's two x-transformer encoders (q, k, v, out; a GEGLU feed-forward
    of ``ff_mult``) over one text and the candidates' codes, and the latent
    projections."""
    inner = dim * ff_mult

    def enc(depth, n, rows):
        per_token = 4 * dim * dim + dim * 2 * inner + inner * dim
        return depth * rows * (2 * n * per_token + 4 * n * n * dim)

    return enc(depth_text, text, 1) + enc(depth_speech, speech, candidates) \
        + 2 * (1 + candidates) * dim * dim


def diffusion_step(c: int, layers: int, frames: list[int], in_ch: int = 100,
                   out_ch: int = 200) -> float:
    """One DiffusionTts evaluation: rows of ``frames`` valid frames each;
    three conditioning and ``layers`` main DiffusionLayers (a ResBlock with
    a dense, a k=3 conv and the time projection, an attention block), the
    input conv, the joining dense, three tail ResBlocks, the output conv;
    the timestep MLP."""
    total = 0.0
    for t in frames:
        resblock = 2 * t * (c * c + 3 * c * c) + 2 * c * 2 * c
        layer = resblock + attention_block(c, t)
        total += (3 + layers) * layer + 3 * resblock + 2 * t * 3 * in_ch * c \
            + 2 * t * 2 * c * c + 2 * t * 3 * c * out_ch + 2 * 2 * c * c
    return total


def univnet(frames: int, noise: int = 64, ch: int = 32, mels: int = 100,
            hops=(8, 64, 256), strides=(8, 8, 4), hidden: int = 64) -> float:
    """One UnivNet-c32 forward over ``frames`` mel frames."""
    total = 2 * frames * 7 * noise * ch + 2 * frames * 256 * 7 * ch
    for hop, s in zip(hops, strides):
        t = frames * hop
        predictor = 2 * frames * (5 * mels * hidden + 6 * 3 * hidden * hidden
                                  + 3 * hidden * (ch * 2 * ch * 3 * 4 + 2 * ch * 4))
        transposed = 2 * (t // s) * ch * ch * 2 * s
        dilated = 4 * 2 * t * 3 * ch * ch
        lvc = 4 * 2 * t * ch * 2 * ch * 3
        total += predictor + transposed + dilated + lvc
    return total


def hifigan(frames: int, c: int = 1024, initial: int = 512, ups=(8, 8, 2, 2),
            up_kernels=(16, 16, 4, 4), kernels=(3, 7, 11)) -> float:
    """HiFi-GAN over ``frames`` interpolated frames (a wav of frames x 256
    samples): conv_pre and the speaker-latent dense, four transposed convs,
    each followed by three type-1 MRF blocks (two convs a dilation, three
    dilations), and conv_post."""
    t = frames
    total = 2 * t * 7 * c * initial + 2 * c * initial
    ch = initial
    for u, k in zip(ups, up_kernels):
        out = ch // 2
        total += 2 * t * ch * out * k
        t *= u
        total += sum(2 * 3 * 2 * t * rk * out * out for rk in kernels)
        ch = out
    return total + 2 * t * 7 * ch
