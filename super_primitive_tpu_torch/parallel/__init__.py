"""The (dp, sp) multi-device layouts over ``torch.distributed``."""
