"""Label conventions and segmentation post-processing."""
