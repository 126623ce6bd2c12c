"""Serving: batched prefill + decode with the FedHeN early-exit head.

The port of ``repro.launch.serve``.  The FedHeN side objective trains the
exit head jointly with the full model, so at serving time one checkpoint
yields two operating points: full-depth decode, and early-exit decode
(the simple sub-network).  A confidence-based adaptive mode emits the exit
head's token when its max probability clears a threshold, otherwise the
full model's; on the batched path both heads are computed and the run
reports how often the exit head agreed with the full model and how often
it was confident.

Prefill runs K5 (flash attention) in every attention layer and K6 (the
RG-LRU scan) in every RG-LRU layer on the card; decode is plain PyTorch,
as the reference's decode is plain jnp.  A multi-codebook config
(musicgen-large) serves ``(B, S, n_codebooks)`` prompts and picks one
token per codebook a step; ``main`` serves a frontend config (the VLM
llava-next-34b) text-only, as the reference's does.  Runs on ``cuda``
unless ``--device cpu``.  ``--checkpoint PATH`` restores a bare params tree
written by ``checkpoint.save_tree`` (by either package) into the freshly
initialised params, as the reference does:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch recurrentgemma-2b --batch 2 --prompt-len 32 --gen 8 \\
        [--checkpoint params.npz]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import restore_tree
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm

# noise(step, shape, dtype) -> standard Gumbel noise of ``shape`` in
# ``dtype`` for one sampled pick: step 0 picks the first token after the
# prefill, step i + 1 decode step i (the reference draws them from its
# unsplit key, then from one split per step); both heads share a step's
# noise, as they share its key in the reference
NoiseProvider = Callable[[int, Tuple[int, ...], torch.dtype], torch.Tensor]


class SeededGumbel:
    """Default noise provider: ``-log(-log(u))`` of f32 uniforms drawn in
    call order from one ``torch.Generator`` (the uniforms clamped to the
    smallest normal f32), rounded to the logits' dtype."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, step: int, shape: Tuple[int, ...],
                 dtype: torch.dtype) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator,
                       device=self.generator.device)
        return -torch.log(-torch.log(u.clamp_min(
            torch.finfo(torch.float32).tiny))).to(dtype)


def generate(params, cfg, prompts: torch.Tensor, gen: int, *,
             adaptive_threshold: float = 0.0, temperature: float = 0.0,
             noise: Optional[NoiseProvider] = None,
             on_prefill_done: Optional[Callable[[], None]] = None):
    """prompts: (B, S) token ids, or (B, S, n_codebooks).  Returns
    ``(tokens (B, S + gen[, n_codebooks]), stats)``; the exit head's
    agreement counts every codebook's token.

    Greedy unless ``temperature > 0``, which samples ``argmax(logits / T +
    gumbel)`` in the logits' dtype, as the reference's
    ``jax.random.categorical(key, logits / T)`` does, with the noise of
    ``noise`` (default: :class:`SeededGumbel` on a generator seeded 0 on the
    prompts' device).  ``on_prefill_done`` is called once the prompt is
    prefilled and the first token picked (a caller's hook for timers and
    counters).

    The adaptive mode (``adaptive_threshold > 0``) is refused for a
    multi-codebook config: the reference's broadcasts the confident mask
    of (B, n_codebooks) tokens to (B, n_codebooks, n_codebooks), and its
    next decode step fails on those tokens."""
    if adaptive_threshold > 0 and cfg.n_codebooks > 1:
        raise ValueError(
            f"adaptive_threshold > 0 with {cfg.n_codebooks} codebooks: the "
            f"reference's adaptive mode broadcasts the confident mask across "
            f"the codebook axis and fails in its next decode step, so it has "
            f"no multi-codebook behaviour to port")
    with torch.inference_mode():
        b, s = prompts.shape[0], prompts.shape[1]
        logits, cache = tfm.prefill(params, cfg, prompts, cache_len=s + gen)
        last = logits[:, -1].clone()
        del logits          # every position's logits: free them for decode
        if noise is None and temperature > 0:
            noise = SeededGumbel(
                torch.Generator(prompts.device).manual_seed(0))

        def draw(step, lg):
            if temperature <= 0:
                return None
            return noise(step, tuple(lg.shape), lg.dtype).to(lg.device)

        def pick(lg, gumbel):
            if gumbel is None:
                return torch.argmax(lg, dim=-1)
            # the temperature is weakly typed in the reference: rounded to
            # the logits' dtype before the division
            t = torch.tensor(temperature, dtype=lg.dtype, device=lg.device)
            return torch.argmax(lg / t + gumbel, dim=-1)

        tok = pick(last, draw(0, last))[:, None]
        out = [prompts, tok]
        if on_prefill_done is not None:
            on_prefill_done()
        exit_agree = exit_confident = 0
        for i in range(gen - 1):
            logits, cache, exit_logits = tfm.decode_step(
                params, cache, cfg, tok, s + i, with_exit_head=True)
            gumbel = draw(i + 1, logits[:, -1])
            full_tok = pick(logits[:, -1], gumbel)
            exit_tok = pick(exit_logits[:, -1], gumbel)
            if adaptive_threshold > 0:
                probs = torch.softmax(exit_logits[:, -1].float(), dim=-1)
                confident = probs.max(dim=-1).values >= adaptive_threshold
                chosen = torch.where(confident, exit_tok, full_tok)
                exit_confident += int(confident.sum())
            else:
                chosen = full_tok
            exit_agree += int((exit_tok == full_tok).sum())
            tok = chosen[:, None]
            out.append(tok)
        tokens = torch.cat(out, dim=1)
    n = b * max(gen - 1, 1) * cfg.n_codebooks
    stats = {"exit_agreement": exit_agree / n,
             "exit_confident_frac": exit_confident / max(b * (gen - 1), 1)}
    return tokens, stats


def load_params(cfg, seed: int, device, checkpoint: str = ""):
    """The served params: drawn from ``seed`` on ``device``, then, with a
    ``checkpoint``, restored from that bare params tree (a trainer
    checkpoint's ``complex/...`` keys raise ``KeyError``, as in the
    reference)."""
    params = tfm.init_params(torch.Generator(device).manual_seed(seed), cfg)
    if checkpoint:
        params, _ = restore_tree(checkpoint, params)
    return params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--adaptive-threshold", type=float, default=0.0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    params = load_params(cfg, args.seed, device, args.checkpoint)
    shape = (args.batch, args.prompt_len) + (
        (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    prompts = torch.randint(
        0, cfg.vocab_size, shape, device=device,
        generator=torch.Generator(device).manual_seed(args.seed + 1))

    t0 = time.perf_counter()
    tokens, stats = generate(params, cfg, prompts, args.gen,
                             adaptive_threshold=args.adaptive_threshold,
                             temperature=args.temperature)
    sample = tokens[0, :24].tolist()        # waits for the device
    dt = time.perf_counter() - t0
    n_new = args.batch * args.gen
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"generated {n_new} tokens in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s on {where})")
    print(f"exit-head agreement with full model: "
          f"{stats['exit_agreement']:.2%}")
    if args.adaptive_threshold > 0:
        print(f"tokens the exit head was confident on: "
              f"{stats['exit_confident_frac']:.2%} "
              f"(these skip {cfg.n_layers - cfg.resolved_exit_layer} of "
              f"{cfg.n_layers} layers)")
    print("sample tokens:", sample)
    return stats


if __name__ == "__main__":
    main()
