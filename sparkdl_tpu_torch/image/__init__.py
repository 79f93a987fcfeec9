"""Image I/O of the port (``imageIO``): the image-struct schema, the
Arrow ↔ NHWC converters and the readers. ``imageSchema`` (a pyarrow type)
is built on first access, so importing this package needs no pyarrow."""

from .imageIO import (decodeImage, encodePng, imageArrayToStruct,
                      imageColumnToNHWC, imageStructToArray, nhwcToStructs,
                      readImages, readImagesWithCustomFn, resizeImage,
                      resizeImageBatchNHWC, structsToNHWC)

__all__ = [
    "imageSchema", "imageArrayToStruct", "imageStructToArray", "decodeImage",
    "encodePng", "resizeImage", "resizeImageBatchNHWC", "structsToNHWC",
    "imageColumnToNHWC", "nhwcToStructs", "readImages",
    "readImagesWithCustomFn",
]


def __getattr__(name):
    if name == "imageSchema":
        from .imageIO import _image_schema
        return _image_schema()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
