"""Evaluation metrics (PyTorch): PSNR, SSIM, sharpness, the CLIP
similarity helpers, LPIPS (VGG16), MUSIQ and WaDIQaM-NR."""
