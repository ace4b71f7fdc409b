from bbdm_tpu_torch.models.factory import build_model

__all__ = ["build_model"]
