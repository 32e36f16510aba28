from dgll_tpu_torch.dataloader.dataloader import DataLoader

__all__ = ["DataLoader"]
