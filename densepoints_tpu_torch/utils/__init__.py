from densepoints_tpu_torch.utils.logging import StageMetrics, log
