"""Amortized learning-curve baselines: the paper's Transformer competitor
(counterpart of ``repro.baselines``).

The paper's headline experimental claim is that the LKGP "can match the
performance of a Transformer on a learning curve prediction task"; this
package provides that Transformer and the head-to-head harness:

* :mod:`~repro_torch.baselines.curve_transformer` - a curve-prediction
  transformer that encodes (hyper-parameter vector, observed curve prefix
  with an explicit missing-value mask) and decodes the full curve as a
  heteroscedastic Gaussian per step, built from :mod:`repro_torch.models`;
* :mod:`~repro_torch.baselines.pretrain` - amortized pre-training on streams
  of synthetic tasks with a curriculum over the observed-prefix fraction,
  through :func:`repro_torch.train.trainer.make_train_step`;
* :mod:`~repro_torch.baselines.evaluate` - scores the LKGP and the
  transformer on identical held-out suites.
"""
from .curve_transformer import (CurveModel, CurveTransformerConfig,
                                build_curve_model, curve_loss, forward,
                                gaussian_nll, layer_table, normalize_t,
                                param_table, predict_task, transformer_stack)
from .evaluate import (cutoff_masks, eval_lkgp, eval_transformer,
                       head_to_head, score_predictions)
from .pretrain import PretrainConfig, pretrain, sample_stream_batch

__all__ = [
    "CurveModel", "CurveTransformerConfig", "build_curve_model",
    "curve_loss", "forward", "gaussian_nll", "layer_table", "normalize_t",
    "param_table", "predict_task", "transformer_stack",
    "PretrainConfig", "pretrain", "sample_stream_batch",
    "cutoff_masks", "eval_lkgp", "eval_transformer", "head_to_head",
    "score_predictions",
]
