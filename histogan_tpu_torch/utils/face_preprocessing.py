"""FFHQ-style face alignment (reference utils/face_preprocessing.py,
itself derived from NVlabs/ffhq-dataset), copied from
``histogan_tpu/utils/face_preprocessing.py``. PIL and scipy are imported
when a face is aligned.

The alignment geometry (oriented crop quad from 68 landmarks, reflect-pad
with blurred fade, quad transform) is implemented standalone; landmark
DETECTION is pluggable because dlib is not available in every
environment. Pass landmarks explicitly, register a detector via
``set_landmark_detector``, or have dlib + the 68-landmark predictor file
installed.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np

_detector: Optional[Callable[[str], np.ndarray]] = None


def set_landmark_detector(fn: Callable[[str], np.ndarray]) -> None:
    """Register a landmark detector: path -> (68, 2) float array."""
    global _detector
    _detector = fn


def _dlib_landmarks(face_file_path: str) -> np.ndarray:
    """Reference detector (utils/face_preprocessing.py:10-53): dlib
    frontal detector + 68-landmark shape predictor."""
    import dlib  # gated: not present in all environments

    predictor_path = os.environ.get(
        "SHAPE_PREDICTOR_PATH", "./utils/shape_predictor_68_face_landmarks.dat"
    )
    detector = dlib.get_frontal_face_detector()
    shape_predictor = dlib.shape_predictor(predictor_path)
    img = dlib.load_rgb_image(face_file_path)
    dets = detector(img, 1)
    if len(dets) < 1:
        raise Exception("No face found!")
    shape = shape_predictor(img, dets[0])
    return np.array([[p.x, p.y] for p in shape.parts()], dtype=np.float64)


def detect_face_landmarks(face_file_path: str) -> np.ndarray:
    if _detector is not None:
        return np.asarray(_detector(face_file_path), np.float64)
    try:
        return _dlib_landmarks(face_file_path)
    except ImportError as e:
        raise RuntimeError(
            "face_extraction needs a landmark detector: dlib is not "
            "installed here. Register one with "
            "histogan_tpu_torch.utils.face_preprocessing.set_landmark_detector "
            "(path -> (68,2) array) or pass landmarks to align_face()."
        ) from e


def align_face(src_file: str, landmarks: np.ndarray, dst_file: str,
               output_size: int = 1024, transform_size: int = 4096,
               enable_padding: bool = True) -> None:
    """FFHQ alignment from 68 landmarks (reference
    utils/face_preprocessing.py:57-166)."""
    import PIL.Image
    import scipy.ndimage

    lm = np.asarray(landmarks, np.float64)
    lm_eye_left = lm[36:42]
    lm_eye_right = lm[42:48]
    lm_mouth_outer = lm[48:60]

    eye_left = lm_eye_left.mean(axis=0)
    eye_right = lm_eye_right.mean(axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm_mouth_outer[0] + lm_mouth_outer[6]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = np.hypot(*x) * 2

    img = PIL.Image.open(src_file).convert("RGB")

    # Shrink
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (int(np.rint(img.size[0] / shrink)),
                 int(np.rint(img.size[1] / shrink)))
        img = img.resize(rsize, PIL.Image.LANCZOS)
        quad /= shrink
        qsize /= shrink

    # Crop
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
            int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, img.size[0]), min(crop[3] + border, img.size[1]))
    if crop[2] - crop[0] < img.size[0] or crop[3] - crop[1] < img.size[1]:
        img = img.crop(crop)
        quad -= crop[0:2]

    # Pad with reflect + blurred fade
    pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
           int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - img.size[0] + border, 0),
           max(pad[3] - img.size[1] + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(np.float32(img),
                     ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), "reflect")
        h, w, _ = arr.shape
        yy, xx, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(xx) / pad[0], np.float32(w - 1 - xx) / pad[2]),
            1.0 - np.minimum(np.float32(yy) / pad[1], np.float32(h - 1 - yy) / pad[3]),
        )
        blur = qsize * 0.02
        arr += (scipy.ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr) * \
            np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = PIL.Image.fromarray(
            np.uint8(np.clip(np.rint(arr), 0, 255)), "RGB"
        )
        quad += pad[:2]

    # Quad transform
    img = img.transform((transform_size, transform_size), PIL.Image.QUAD,
                        (quad + 0.5).flatten(), PIL.Image.BILINEAR)
    if output_size < transform_size:
        img = img.resize((output_size, output_size), PIL.Image.LANCZOS)

    Path(dst_file).parent.mkdir(parents=True, exist_ok=True)
    img.save(dst_file)


def face_extraction(face_file_path: str, dst_dir: str = "./temp-faces/",
                    output_size: int = 1024) -> str:
    """Detect, align and save; returns the output path
    (reference utils/face_preprocessing.py:175-205)."""
    landmarks = detect_face_landmarks(face_file_path)
    filename = os.path.split(face_file_path)[-1]
    dst = os.path.join(dst_dir, filename)
    align_face(face_file_path, landmarks, dst, output_size=output_size)
    return dst
