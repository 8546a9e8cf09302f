"""lm-evaluation-harness adapter for the Mamba LM, port of
`dimsum_tpu/eval/lm_harness.py` (reference evals/lm_harness_eval.py: an
`HFLM` subclass registering the Mamba LM as "mamba").

  * `MambaScorer`: teacher-forced scoring through the full forward (the
    scan kernel on the card): `loglikelihood(prefix, continuation)` returns
    the (logprob sum, is_greedy) pair every lm-eval task consumes, with the
    sequence padded to a power-of-two length bucket of at least 32 and at
    most `max_length`; `loglikelihood_rolling`; `greedy_until` through
    `generate` at temperature 0.
  * `MambaEvalWrapper`: the `lm_eval.api.model.LM` subclass under the name
    "mamba", defined only where `lm_eval` imports (it is not installed
    here); `python -m dimsum_torch.eval.lm_harness` is the reference's
    `cli_evaluate()` and raises ImportError without it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from dimsum_torch.models.lm import MambaLMHeadModel, generate

__all__ = ["MambaScorer", "MambaEvalWrapper", "cli_evaluate"]


class MambaScorer:
    """Teacher-forced log-likelihood scoring and greedy generation of one
    MambaLMHeadModel on its device."""

    def __init__(self, model: MambaLMHeadModel, max_length: int = 2048):
        self.model = model
        self.max_length = max_length
        self.device = next(model.parameters()).device

    def _bucket(self, n: int) -> int:
        """The padded length: the least power of two >= n from 32 up, at
        most max_length (the JAX jit cache's buckets)."""
        b = 32
        while b < n:
            b *= 2
        return min(b, self.max_length)

    @torch.no_grad()
    def logits(self, ids: List[int]) -> torch.Tensor:
        """fp32 logits (len(ids), V) of one sequence, run padded with zeros
        to its bucket (the padding comes after it, so it changes nothing
        before it: the model is causal)."""
        padded = torch.zeros(1, self._bucket(len(ids)), dtype=torch.long,
                             device=self.device)
        padded[0, :len(ids)] = torch.as_tensor(ids, device=self.device)
        return self.model(padded)[0, :len(ids)]

    def loglikelihood(self, prefix: List[int],
                      continuation: List[int]) -> Tuple[float, bool]:
        """Sum of the continuation tokens' log-probabilities under teacher
        forcing, and whether each is the argmax (lm-eval's `loglikelihood`
        contract).  The sequence keeps its last max_length tokens."""
        ids = (list(prefix) + list(continuation))[-self.max_length:]
        n_cont = min(len(continuation), len(ids) - 1)
        logits = self.logits(ids)
        # token t is predicted from position t - 1
        tgt = torch.as_tensor(ids[len(ids) - n_cont:], device=self.device)
        pred = logits[len(ids) - n_cont - 1:len(ids) - 1]
        logp = torch.log_softmax(pred, dim=-1)
        token_logp = logp[torch.arange(n_cont, device=self.device), tgt]
        greedy = bool((pred.argmax(-1) == tgt).all())
        return float(token_logp.sum()), greedy

    def loglikelihood_rolling(self, tokens: List[int]) -> float:
        """The whole sequence's log-likelihood, its first token unscored."""
        ll, _ = self.loglikelihood(tokens[:1], tokens[1:])
        return ll

    def greedy_until(self, prompt: List[int], max_new_tokens: int,
                     stop_tokens: Optional[List[int]] = None) -> List[int]:
        """Greedy continuation of `prompt`, cut before the first stop
        token."""
        ids = torch.as_tensor([prompt], device=self.device)
        out = generate(self.model, ids, max_new_tokens, temperature=0.0)
        new = out[0, len(prompt):].tolist()
        if stop_tokens:
            for i, t in enumerate(new):
                if t in stop_tokens:
                    return new[:i]
        return new


try:  # pragma: no cover - lm_eval is not installed
    from lm_eval.api.model import LM
    from lm_eval.api.registry import register_model

    @register_model("mamba")
    class MambaEvalWrapper(LM):
        """lm-eval adapter (reference lm_harness_eval.py:11-38): a local HF
        checkpoint through `dimsum_torch.utils.hf.load_hf_mamba`, scored on
        the card (or on `device`)."""

        def __init__(self, pretrained: str, max_length: int = 2048,
                     batch_size=None, device="cuda", dtype=None):
            super().__init__()
            from transformers import AutoTokenizer

            from dimsum_torch.utils.hf import load_hf_mamba

            _, model = load_hf_mamba(pretrained, device=device,
                                     dtype=dtype or torch.float32)
            self.scorer = MambaScorer(model, max_length=max_length)
            self.tokenizer = AutoTokenizer.from_pretrained(
                "EleutherAI/gpt-neox-20b")
            self.tokenizer.pad_token_id = self.tokenizer.eos_token_id

        def loglikelihood(self, requests):
            out = []
            for req in requests:
                ctx, cont = req.args
                pre = self.tokenizer(ctx)["input_ids"]
                tgt = self.tokenizer(cont)["input_ids"]
                out.append(self.scorer.loglikelihood(pre, tgt))
            return out

        def loglikelihood_rolling(self, requests):
            return [
                self.scorer.loglikelihood_rolling(
                    self.tokenizer(req.args[0])["input_ids"])
                for req in requests
            ]

        def generate_until(self, requests):
            out = []
            for req in requests:
                ctx, kwargs = req.args
                ids = self.tokenizer(ctx)["input_ids"]
                until = kwargs.get("until", [])
                stop = [t for s in until
                        for t in self.tokenizer(s)["input_ids"][:1]]
                new = self.scorer.greedy_until(
                    ids, kwargs.get("max_gen_toks", 128), stop)
                out.append(self.tokenizer.decode(new))
            return out

    def cli_evaluate():  # the reference's __main__
        from lm_eval.__main__ import cli_evaluate as _cli

        _cli()

except ImportError:
    MambaEvalWrapper = None

    def cli_evaluate():
        raise ImportError(
            "lm_eval is not installed; MambaScorer works standalone, the "
            "harness CLI needs `pip install lm-eval` on a networked machine")


if __name__ == "__main__":  # pragma: no cover
    cli_evaluate()
