"""AI-service transformers (host-side).

Reference: module ``cognitive`` (~10.1k LoC, ~65 transformers; SURVEY.md §2.8).
All build on the base machinery in base.py (ServiceParams, auth, retries,
concurrency, shared LRO polling) over the io/http layer — no device work.
Implemented families: OpenAI, language/text analytics, translate (incl.
document translation), vision + face ops, anomaly (incl. the multivariate
fit lifecycle), speech (REST + streaming websocket SDK), document
intelligence (incl. custom-model management and ontology learning), search,
Bing, geospatial.

The port's copy of the JAX package's ``services/`` (host code; the
port imports nothing of that package). Request bodies are the JAX
package's byte for byte: the dicts are built in the same order and
dumped with the same ``json.dumps`` arguments.
"""

from .base import (CognitiveServiceBase, HasAsyncReply, HasServiceParams,
                   HasSetLocation)
from .openai import (OpenAIChatCompletion, OpenAICompletion, OpenAIEmbedding,
                     OpenAIPrompt)
from .language import (NER, PII, AnalyzeHealthText, AnalyzeText,
                       EntityDetector, EntityLinking, KeyPhraseExtractor,
                       LanguageDetector, TextAnalyze, TextSentiment)
from .translate import (BreakSentence, Detect, DictionaryExamples,
                        DictionaryLookup, DocumentTranslator, Translate,
                        Transliterate)
from .vision import (OCR, AnalyzeImage, DescribeImage, DetectFace,
                     FindSimilarFace, GenerateThumbnails, GroupFaces,
                     IdentifyFaces, ReadImage,
                     RecognizeDomainSpecificContent, RecognizeText, TagImage,
                     VerifyFaces)
from .anomaly import (DetectAnomalies, DetectLastAnomaly,
                      DetectLastMultivariateAnomaly, DetectMultivariateAnomaly,
                      SimpleDetectAnomalies, SimpleDetectMultivariateAnomaly,
                      SimpleFitMultivariateAnomaly)
from .speech import (AnalyzeDocument, ConversationTranscription,
                     SpeakerEmotionInference, SpeechToText, SpeechToTextSDK,
                     TextToSpeech)
from .search import AddDocuments, AzureSearchWriter, BingImageSearch
from .geospatial import (AddressGeocoder, CheckPointInPolygon,
                         ReverseAddressGeocoder)
from .form import (AnalyzeBusinessCards, AnalyzeCustomModel,
                   AnalyzeDocumentRead, AnalyzeIDDocuments, AnalyzeInvoices,
                   AnalyzeLayout, AnalyzeReceipts, FormOntologyLearner,
                   FormOntologyTransformer, GetCustomModel, ListCustomModels)

__all__ = [
    "CognitiveServiceBase", "HasAsyncReply", "HasServiceParams",
    "HasSetLocation",
    "OpenAICompletion", "OpenAIChatCompletion", "OpenAIEmbedding",
    "OpenAIPrompt",
    "TextSentiment", "KeyPhraseExtractor", "NER", "PII", "EntityLinking",
    "EntityDetector", "LanguageDetector", "AnalyzeHealthText", "AnalyzeText",
    "TextAnalyze",
    "Translate", "Transliterate", "Detect", "BreakSentence",
    "DictionaryLookup", "DictionaryExamples", "DocumentTranslator",
    "AnalyzeImage", "DescribeImage", "TagImage", "OCR", "GenerateThumbnails",
    "ReadImage", "RecognizeText", "RecognizeDomainSpecificContent",
    "DetectFace", "FindSimilarFace", "GroupFaces", "IdentifyFaces",
    "VerifyFaces",
    "DetectLastAnomaly", "DetectAnomalies", "SimpleDetectAnomalies",
    "DetectMultivariateAnomaly", "DetectLastMultivariateAnomaly",
    "SimpleFitMultivariateAnomaly", "SimpleDetectMultivariateAnomaly",
    "SpeechToText", "SpeechToTextSDK", "ConversationTranscription",
    "SpeakerEmotionInference", "TextToSpeech", "AnalyzeDocument",
    "AzureSearchWriter", "AddDocuments", "BingImageSearch",
    "AddressGeocoder", "ReverseAddressGeocoder", "CheckPointInPolygon",
    "AnalyzeLayout", "AnalyzeReceipts", "AnalyzeBusinessCards",
    "AnalyzeInvoices", "AnalyzeIDDocuments", "AnalyzeDocumentRead",
    "AnalyzeCustomModel", "GetCustomModel", "ListCustomModels",
    "FormOntologyLearner", "FormOntologyTransformer",
]
