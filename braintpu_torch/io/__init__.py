"""I/O layer: the pure-Python NIfTI-1 codec and BraTS case discovery."""

from . import nifti
from .brats import (
    MODALITIES,
    MODALITY_CHANNEL,
    BratsCase,
    convert_filename_2025_to_2021,
    find_cases,
    load_case_volumes,
    rename_brats2025_folder,
)
from .nifti import NiftiImage, load, save

__all__ = [
    "nifti",
    "NiftiImage",
    "load",
    "save",
    "MODALITIES",
    "MODALITY_CHANNEL",
    "BratsCase",
    "convert_filename_2025_to_2021",
    "find_cases",
    "load_case_volumes",
    "rename_brats2025_folder",
]
