"""Azure AI Vision + Face transformers.

Reference: cognitive/.../services/vision/ComputerVision.scala (~787 LoC:
AnalyzeImage, DescribeImage, OCR, RecognizeText, TagImage, GenerateThumbnails)
and services/face/Face.scala (DetectFace, ...). Images go either as a URL
(``imageUrlCol``) or raw bytes (``imageBytesCol``, octet-stream body).

The port's copy of the JAX package's ``services/vision.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations


from ..core.params import Param
from .base import HasAsyncReply, HasSetLocation


class _VisionBase(HasSetLocation):
    imageUrlCol = Param("imageUrlCol", "column of image urls", str)
    imageBytesCol = Param("imageBytesCol", "column of image bytes", str)
    urlPath = "vision/v3.2/analyze"

    def _prepare_headers(self, df, i):
        h = super()._prepare_headers(df, i)
        if self.isSet("imageBytesCol"):
            h["Content-Type"] = "application/octet-stream"
        return h

    def _prepare_body(self, df, i):
        if self.isSet("imageBytesCol"):
            b = df[self.getImageBytesCol()][i]
            return bytes(b) if b is not None else None
        if self.isSet("imageUrlCol"):
            u = df[self.getImageUrlCol()][i]
            return {"url": str(u)} if u is not None else None
        raise ValueError(f"{type(self).__name__}: set imageUrlCol or "
                         "imageBytesCol")


class AnalyzeImage(_VisionBase):
    visualFeatures = Param("visualFeatures", "features to extract", list,
                           ["Categories"])
    details = Param("details", "detail domains", list)
    descriptionExclude = Param("descriptionExclude", "models to exclude", list)

    def _prepare_url(self, df, i):
        q = "?visualFeatures=" + ",".join(self.getVisualFeatures())
        d = self.get("details")
        if d:
            q += "&details=" + ",".join(d)
        return super()._prepare_url(df, i) + q


class DescribeImage(_VisionBase):
    urlPath = "vision/v3.2/describe"
    maxCandidates = Param("maxCandidates", "number of captions", int, 1)

    def _prepare_url(self, df, i):
        return (super()._prepare_url(df, i)
                + f"?maxCandidates={self.getMaxCandidates()}")


class TagImage(_VisionBase):
    urlPath = "vision/v3.2/tag"


class OCR(_VisionBase):
    urlPath = "vision/v3.2/ocr"
    detectOrientation = Param("detectOrientation", "detect text orientation",
                              bool, True)

    def _prepare_url(self, df, i):
        return (super()._prepare_url(df, i)
                + f"?detectOrientation={str(self.getDetectOrientation()).lower()}")


class GenerateThumbnails(_VisionBase):
    urlPath = "vision/v3.2/generateThumbnail"
    width = Param("width", "thumbnail width", int, 64)
    height = Param("height", "thumbnail height", int, 64)
    smartCropping = Param("smartCropping", "smart-crop", bool, True)

    def _prepare_url(self, df, i):
        return (super()._prepare_url(df, i)
                + f"?width={self.getWidth()}&height={self.getHeight()}"
                  f"&smartCropping={str(self.getSmartCropping()).lower()}")

    def _parse_response(self, parsed, df, i):
        return parsed  # thumbnail bytes (non-JSON) come back as text fallback


class DetectFace(_VisionBase):
    urlPath = "face/v1.0/detect"
    returnFaceAttributes = Param("returnFaceAttributes", "attributes to return",
                                 list)
    returnFaceLandmarks = Param("returnFaceLandmarks", "return landmarks",
                                bool, False)

    def _prepare_url(self, df, i):
        q = f"?returnFaceLandmarks={str(self.getReturnFaceLandmarks()).lower()}"
        attrs = self.get("returnFaceAttributes")
        if attrs:
            q += "&returnFaceAttributes=" + ",".join(attrs)
        return super()._prepare_url(df, i) + q


class ReadImage(HasAsyncReply, _VisionBase):
    """Async Read OCR (reference vision/ComputerVision.scala ReadImage): POST
    returns 202 + Operation-Location; the shared HasAsyncReply flow polls it
    until succeeded/failed (synthetic 504 on poll exhaustion)."""

    urlPath = "vision/v3.2/read/analyze"


class RecognizeText(ReadImage):
    """Legacy recognizeText endpoint (reference RecognizeText) — same async
    submit/poll protocol as Read."""

    urlPath = "vision/v2.0/recognizeText"
    mode = Param("mode", "Handwritten|Printed", str, "Printed")

    def _prepare_url(self, df, i):
        return _VisionBase._prepare_url(self, df, i) + f"?mode={self.getMode()}"


class RecognizeDomainSpecificContent(_VisionBase):
    """Domain-model analysis, e.g. celebrities/landmarks (reference
    RecognizeDomainSpecificContent)."""

    model = Param("model", "domain model name", str, "celebrities")

    def _prepare_url(self, df, i):
        u = self.get("url")
        if not u:
            raise ValueError("set url or location first")
        base = u.split("/vision/")[0]
        return f"{base}/vision/v3.2/models/{self.getModel()}/analyze"


class _FaceIdBase(HasSetLocation):
    """Face ops over previously-detected faceIds (reference face/Face.scala:
    json bodies, no image payload)."""

    def _json_cols(self, df, i, mapping):
        body = {}
        for key, (pname, required) in mapping.items():
            v = self._resolve(pname, df, i)
            if v is None and required:
                return None
            if v is not None:
                body[key] = v.tolist() if hasattr(v, "tolist") else v
        return body


class FindSimilarFace(_FaceIdBase):
    urlPath = "face/v1.0/findsimilars"
    faceIdCol = Param("faceIdCol", "query faceId column", str, "faceId")
    faceListId = Param("faceListId", "face list to search", str)
    faceIds = Param("faceIds", "candidate faceIds", is_complex=True)
    maxNumOfCandidatesReturned = Param("maxNumOfCandidatesReturned",
                                       "max candidates", int, 20)
    mode = Param("mode", "matchPerson|matchFace", str, "matchPerson")

    def _prepare_body(self, df, i):
        fid = df[self.getFaceIdCol()][i]
        if fid is None:
            return None
        body = {"faceId": str(fid),
                "maxNumOfCandidatesReturned":
                    self.getMaxNumOfCandidatesReturned(),
                "mode": self.getMode()}
        if self.isSet("faceListId"):
            body["faceListId"] = self.get("faceListId")
        ids = self._resolve("faceIds", df, i)
        if ids is not None:
            body["faceIds"] = list(ids)
        return body


class GroupFaces(_FaceIdBase):
    urlPath = "face/v1.0/group"
    faceIdsCol = Param("faceIdsCol", "column of faceId lists", str, "faceIds")

    def _prepare_body(self, df, i):
        ids = df[self.getFaceIdsCol()][i]
        return {"faceIds": list(ids)} if ids is not None else None


class IdentifyFaces(_FaceIdBase):
    urlPath = "face/v1.0/identify"
    faceIdsCol = Param("faceIdsCol", "column of faceId lists", str, "faceIds")
    personGroupId = Param("personGroupId", "person group", str)
    largePersonGroupId = Param("largePersonGroupId", "large person group", str)
    maxNumOfCandidatesReturned = Param("maxNumOfCandidatesReturned",
                                       "max candidates", int, 1)
    confidenceThreshold = Param("confidenceThreshold", "identify threshold",
                                float)

    def _prepare_body(self, df, i):
        ids = df[self.getFaceIdsCol()][i]
        if ids is None:
            return None
        body = {"faceIds": list(ids),
                "maxNumOfCandidatesReturned":
                    self.getMaxNumOfCandidatesReturned()}
        for k in ("personGroupId", "largePersonGroupId"):
            if self.isSet(k):
                body[k] = self.get(k)
        thr = self.get("confidenceThreshold")
        if thr is not None:
            body["confidenceThreshold"] = thr
        return body


class VerifyFaces(_FaceIdBase):
    urlPath = "face/v1.0/verify"
    faceId1Col = Param("faceId1Col", "first faceId column", str, "faceId1")
    faceId2Col = Param("faceId2Col", "second faceId column", str, "faceId2")

    def _prepare_body(self, df, i):
        f1 = df[self.getFaceId1Col()][i]
        f2 = df[self.getFaceId2Col()][i]
        if f1 is None or f2 is None:
            return None
        return {"faceId1": str(f1), "faceId2": str(f2)}
