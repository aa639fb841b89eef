"""Datasets: port of deeplearning4j_tpu/datasets/ — the containers, the
iterators (`AsyncDataSetIterator` stages on CUDA streams), the
normalizers, MNIST / Iris, the CIFAR / Curves / LFW fetchers and the
record readers."""
from .dataset import DataSet, MultiDataSet
from .fetchers import (CifarDataSetIterator, CurvesDataSetIterator,
                       LFWDataSetIterator)
from .iterators import (ArraysDataSetIterator, AsyncDataSetIterator,
                        AsyncMultiDataSetIterator,
                        CombinedPreProcessor, DataSetIterator,
                        ExistingDataSetIterator,
                        IteratorDataSetIterator,
                        ListDataSetIterator,
                        MovingWindowDataSetIterator,
                        MultipleEpochsIterator,
                        ReconstructionDataSetIterator,
                        SamplingDataSetIterator)
from .mnist import IrisDataSetIterator, MnistDataSetIterator
from .normalizers import (ImagePreProcessingScaler, NormalizerMinMaxScaler,
                          NormalizerStandardize)
from .records import (CollectionRecordReader, CSVRecordReader,
                      CSVSequenceRecordReader, RecordReader,
                      RecordReaderDataSetIterator,
                      RecordReaderMultiDataSetIterator,
                      SequenceRecordReaderDataSetIterator)

__all__ = [
    "ArraysDataSetIterator", "AsyncDataSetIterator",
    "AsyncMultiDataSetIterator", "CSVRecordReader",
    "CSVSequenceRecordReader",
    "CifarDataSetIterator", "CollectionRecordReader", "CurvesDataSetIterator",
    "CombinedPreProcessor", "DataSet", "DataSetIterator",
    "ExistingDataSetIterator", "ImagePreProcessingScaler",
    "IrisDataSetIterator", "IteratorDataSetIterator", "LFWDataSetIterator",
    "ListDataSetIterator", "MnistDataSetIterator",
    "MovingWindowDataSetIterator", "MultiDataSet",
    "MultipleEpochsIterator", "NormalizerMinMaxScaler",
    "NormalizerStandardize", "RecordReader", "RecordReaderDataSetIterator",
    "ReconstructionDataSetIterator", "RecordReaderMultiDataSetIterator",
    "SamplingDataSetIterator",
    "SequenceRecordReaderDataSetIterator",
]
