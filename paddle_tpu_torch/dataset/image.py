"""Image preprocessing utilities (reference: python/paddle/dataset/image.py
— resize/crop/flip/transform helpers used by the image datasets and the
imagenet benchmark reader).

The reference decodes with cv2; this package decodes no JPEG or PNG, so
load_image* accept .npy arrays (HWC uint8) or raw ndarray bytes, and every
transform is pure numpy with the reference's semantics: images flow HWC
until to_chw.
"""
import io
import os

import numpy as np

__all__ = ["load_image", "load_image_bytes", "resize_short", "to_chw",
           "center_crop", "random_crop", "left_right_flip",
           "simple_transform", "load_and_transform", "batch_images_from_tar"]


def load_image(file, is_color=True):
    """Load an image as an HWC (or HW when not is_color) uint8 array.
    Accepts .npy files (the decoded-array cache convention used by the
    datasets here, see voc2012.py)."""
    if isinstance(file, str) and file.endswith(".npy"):
        im = np.load(file)
    else:
        with open(file, "rb") as f:
            im = load_image_bytes(f.read(), is_color)
    return _color_shape(im, is_color)


def load_image_bytes(bytes_, is_color=True):
    """Decode image bytes. Supports the numpy .npy serialization (no cv2 in
    codec here — reference :141 decodes jpeg/png)."""
    im = np.load(io.BytesIO(bytes_), allow_pickle=False)
    return _color_shape(im, is_color)


def _color_shape(im, is_color):
    im = np.asarray(im)
    if is_color and im.ndim == 2:
        im = np.repeat(im[:, :, None], 3, axis=2)
    if not is_color and im.ndim == 3:
        im = im.mean(axis=2).astype(im.dtype)
    return im


def resize_short(im, size):
    """Scale so the SHORT edge becomes `size`, keeping aspect (reference
    :197) — nearest-neighbor resampling (numpy-only build)."""
    h, w = im.shape[:2]
    if h < w:
        out_h, out_w = size, max(int(round(w * size / float(h))), 1)
    else:
        out_h, out_w = max(int(round(h * size / float(w))), 1), size
    rows = np.clip((np.arange(out_h) * h / out_h).astype(int), 0, h - 1)
    cols = np.clip((np.arange(out_w) * w / out_w).astype(int), 0, w - 1)
    return im[rows][:, cols]


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (reference :225)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    """Crop the center size x size window (reference :249)."""
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im, size, is_color=True):
    """Crop a random size x size window (reference :277)."""
    h, w = im.shape[:2]
    h_start = np.random.randint(0, h - size + 1)
    w_start = np.random.randint(0, w - size + 1)
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im, is_color=True):
    """Mirror horizontally (reference :305)."""
    return im[:, ::-1] if im.ndim == 2 or is_color else im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short -> crop (random+flip when training, center otherwise)
    -> CHW float32 -> optional mean subtraction (reference :327)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.asarray(mean, "float32")
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    """load_image + simple_transform (reference :383)."""
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pre-batch a tar of images into pickled numpy batches (reference
    :80). Here the tar members are .npy images; emits <data_file>_batch/
    batch-N pickle files and a meta file listing them."""
    import pickle
    import tarfile
    out_path = "%s_batch" % data_file
    os.makedirs(out_path, exist_ok=True)
    data, labels, file_id, names = [], [], 0, []
    with tarfile.open(data_file) as tf:
        for mem in tf.getmembers():
            if not mem.isfile() or mem.name not in img2label:
                continue
            arr = load_image_bytes(tf.extractfile(mem).read())
            data.append(arr)
            labels.append(img2label[mem.name])
            if len(data) == num_per_batch:
                names.append(_dump_batch(out_path, file_id, data, labels,
                                         pickle))
                data, labels, file_id = [], [], file_id + 1
    if data:
        names.append(_dump_batch(out_path, file_id, data, labels, pickle))
    with open(os.path.join(out_path, "meta"), "w") as f:
        f.write("\n".join(names))
    return out_path


def _dump_batch(out_path, file_id, data, labels, pickle):
    name = os.path.join(out_path, "batch-%05d" % file_id)
    with open(name, "wb") as f:
        pickle.dump({"data": np.asarray(data, dtype=object),
                     "label": labels}, f, protocol=2)
    return name
