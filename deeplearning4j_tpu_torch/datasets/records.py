"""Record readers + RecordReader->DataSet adapters (the DataVec bridge).

The port's copy of deeplearning4j_tpu/datasets/records.py (numpy and csv).
As in the reference, `CSVRecordReader` parses a numeric file with the native
C++ parser through the port's own loader (common/native_ops.py; float
values) and falls back to Python's csv module (strings; the iterators
convert them with float()) for other content or without the library.
`CSVSequenceRecordReader(prefetch>0)` parses on the native loader's worker
threads (`PrefetchCsvLoader`), and on the Python parser, with the same
float contract, only without the library.

TPU-native equivalent of the reference's DataVec integration:
- RecordReader SPI (DataVec's CSVRecordReader / CSVSequenceRecordReader /
  CollectionRecordReader)
- datasets/datavec/RecordReaderDataSetIterator.java (label column ->
  classification one-hot or regression targets)
- datasets/datavec/SequenceRecordReaderDataSetIterator.java (aligned feature
  + label sequence files, or single reader with label column)
"""
from __future__ import annotations

import csv
import os

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator


class RecordReader:
    """DataVec RecordReader SPI: iterate lists of values."""

    def has_next(self):
        raise NotImplementedError

    hasNext = has_next

    def next_record(self):
        raise NotImplementedError

    next = next_record

    def reset(self):
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_record()


class CollectionRecordReader(RecordReader):
    """In-memory records (DataVec CollectionRecordReader)."""

    def __init__(self, records):
        self._records = [list(r) for r in records]
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._records)

    def next_record(self):
        r = self._records[self._pos]
        self._pos += 1
        return r

    def reset(self):
        self._pos = 0


class CSVRecordReader(RecordReader):
    """CSV file -> records (DataVec CSVRecordReader; skip_lines mirrors its
    skipNumLines, delimiter its delimiter)."""

    def __init__(self, path=None, skip_lines=0, delimiter=","):
        self.path = path
        self.skip_lines = int(skip_lines)
        self.delimiter = delimiter
        self._records = None
        if path is not None:
            self.initialize(path)

    def initialize(self, path):
        self.path = str(path)
        # numeric fast path: the native C++ parser (common/native_ops);
        # non-numeric content makes it return None -> python csv fallback
        from ..common import native_ops
        mat = native_ops.parse_csv(self.path, self.delimiter,
                                   self.skip_lines)
        if mat is not None:
            self._records = [row.tolist() for row in mat]
        else:
            with open(self.path, "r", encoding="utf-8", newline="") as fh:
                rows = list(csv.reader(fh, delimiter=self.delimiter))
            self._records = [r for r in rows[self.skip_lines:] if r]
        self._pos = 0
        return self

    def has_next(self):
        return self._pos < len(self._records)

    def next_record(self):
        r = self._records[self._pos]
        self._pos += 1
        return r

    def reset(self):
        self._pos = 0


class CSVSequenceRecordReader(RecordReader):
    """One CSV file per sequence (DataVec CSVSequenceRecordReader). Files are
    visited in sorted order under `directory` (or from an explicit list).

    prefetch > 0 (numeric files only): that many native worker threads
    parse files concurrently off the GIL (`common/native_ops
    PrefetchCsvLoader`); sequences still arrive in file order. Type
    contract: prefetch > 0 declares the files numeric and always yields
    float values, also on the Python route taken when the native library
    is unavailable (which raises ValueError on non-numeric content).
    prefetch == 0 yields raw strings."""

    def __init__(self, directory=None, files=None, skip_lines=0,
                 delimiter=",", prefetch=0):
        self.skip_lines = int(skip_lines)
        self.delimiter = delimiter
        self.prefetch = int(prefetch)
        if files is not None:
            self.files = [str(f) for f in files]
        elif directory is not None:
            self.files = sorted(
                os.path.join(directory, f) for f in os.listdir(directory))
        else:
            self.files = []
        self._pos = 0
        self._loader = None

    def has_next(self):
        return self._pos < len(self.files)

    def _native_loader(self):
        if self._loader is None:
            from ..common import native_ops
            if not native_ops.available():
                return None
            self._loader = native_ops.PrefetchCsvLoader(
                self.files, delimiter=self.delimiter,
                skip_lines=self.skip_lines, n_threads=self.prefetch,
                capacity=max(2 * self.prefetch, 4))
        return self._loader

    def next_sequence(self):
        if self.prefetch > 0:
            loader = self._native_loader()
            if loader is not None:
                # advance before the native call: the loader's cursor moves
                # even when a file fails to parse, so _pos must too
                self._pos += 1
                return loader.next().tolist()
        path = self.files[self._pos]
        self._pos += 1
        with open(path, "r", encoding="utf-8", newline="") as fh:
            rows = list(csv.reader(fh, delimiter=self.delimiter))
        rows = [r for r in rows[self.skip_lines:] if r]
        if self.prefetch > 0:
            try:
                return [[float(v) for v in r] for r in rows]
            except ValueError as e:
                raise ValueError(
                    f"prefetch>0 declares numeric files, but {path} has "
                    f"non-numeric content; use prefetch=0 for raw string "
                    f"records") from e
        return rows

    next_record = next_sequence

    def reset(self):
        self._pos = 0
        if self._loader is not None:
            self._loader.close()
            self._loader = None


class RecordReaderDataSetIterator(DataSetIterator):
    """reference: datasets/datavec/RecordReaderDataSetIterator.java.

    Classification: label_index column holds the class id -> one-hot of
    num_classes. Regression: regression=True, label column(s) kept as
    float targets (label_index..label_index_to inclusive)."""

    def __init__(self, record_reader, batch_size, label_index=-1,
                 num_classes=None, regression=False, label_index_to=None,
                 collect_meta_data=False):
        self.reader = record_reader
        self.batch_size = int(batch_size)
        self.label_index = label_index
        self.label_index_to = label_index_to
        self.num_classes = num_classes
        self.regression = regression
        # reference setCollectMetaData: batches carry (source, row) records
        # so Evaluation's Prediction queries can point back at inputs
        self.collect_meta_data = bool(collect_meta_data)
        self._row = 0
        self.reader.reset()

    setCollectMetaData = lambda self, v: setattr(
        self, "collect_meta_data", bool(v)) or self

    def has_next(self):
        return self.reader.has_next()

    def next_batch(self):
        feats, labels, metas = [], [], []
        src = getattr(self.reader, "path", None)
        while self.reader.has_next() and len(feats) < self.batch_size:
            rec = [float(v) for v in self.reader.next_record()]
            f, l = self._split(rec)
            feats.append(f)
            labels.append(l)
            metas.append((src, self._row))
            self._row += 1
        x = np.asarray(feats, np.float32)
        if self.regression:
            y = np.asarray(labels, np.float32)
        else:
            y = np.eye(self.num_classes, dtype=np.float32)[
                np.asarray(labels, np.int64).ravel()]
        ds = DataSet(x, y)
        if self.collect_meta_data:
            ds.example_metas = metas
        return ds

    def _split(self, rec):
        li = self.label_index if self.label_index >= 0 else len(rec) - 1
        lj = self.label_index_to if self.label_index_to is not None else li
        label = rec[li:lj + 1]
        feat = rec[:li] + rec[lj + 1:]
        return feat, label

    def reset(self):
        self._row = 0
        self.reader.reset()

    def batch(self):
        return self.batch_size

    def total_outcomes(self):
        return self.num_classes or -1


class RecordReaderMultiDataSetIterator:
    """Build MultiDataSets from one or more record readers — the multi-input/
    multi-output feed for ComputationGraph.fit.

    reference: datasets/datavec/RecordReaderMultiDataSetIterator.java — the
    Builder registers named readers, then declares which column ranges of
    which reader become which input/output arrays:

        it = (RecordReaderMultiDataSetIterator.Builder(batch_size=16)
              .add_reader("csv", reader)
              .add_input("csv", 0, 3)              # cols 0..3 -> input 0
              .add_input("csv", 4, 5)              # cols 4..5 -> input 1
              .add_output_one_hot("csv", 6, 4)     # col 6 -> one-hot(4)
              .add_output("csv", 7, 7)             # col 7 -> regression
              .build())
    """

    class Builder:
        def __init__(self, batch_size):
            self._batch = int(batch_size)
            self._readers = {}
            self._inputs = []    # (reader, from, to)
            self._outputs = []   # (reader, from, to, one_hot_classes|None)

        def add_reader(self, name, reader):
            self._readers[str(name)] = reader; return self

        addReader = add_reader

        def add_input(self, reader_name, col_from=0, col_to=None):
            self._inputs.append((str(reader_name), int(col_from),
                                 col_to if col_to is None else int(col_to)))
            return self

        addInput = add_input

        def add_output(self, reader_name, col_from=0, col_to=None):
            self._outputs.append((str(reader_name), int(col_from),
                                  col_to if col_to is None else int(col_to),
                                  None))
            return self

        addOutput = add_output

        def add_output_one_hot(self, reader_name, column, num_classes):
            self._outputs.append((str(reader_name), int(column), int(column),
                                  int(num_classes)))
            return self

        addOutputOneHot = add_output_one_hot

        def build(self):
            if not self._inputs or not self._outputs:
                raise ValueError("Need at least one input and one output")
            for name, *_ in self._inputs + self._outputs:
                if name not in self._readers:
                    raise ValueError(f"No reader registered as '{name}'")
            return RecordReaderMultiDataSetIterator(
                self._batch, self._readers, self._inputs, self._outputs)

    def __init__(self, batch_size, readers, inputs, outputs):
        self.batch_size = int(batch_size)
        self.readers = readers
        self.inputs = inputs
        self.outputs = outputs
        self.reset()

    def has_next(self):
        return all(r.has_next() for r in self.readers.values())

    def next_batch(self):
        from .dataset import MultiDataSet
        rows = {name: [] for name in self.readers}
        n = 0
        while self.has_next() and n < self.batch_size:
            for name, r in self.readers.items():
                rows[name].append([float(v) for v in r.next_record()])
            n += 1
        mats = {name: np.asarray(v, np.float32) for name, v in rows.items()}

        def cols(m, c0, c1):
            c1 = m.shape[1] - 1 if c1 is None else c1
            return m[:, c0:c1 + 1]

        feats = [cols(mats[name], c0, c1) for name, c0, c1 in self.inputs]
        labels = []
        for name, c0, c1, onehot in self.outputs:
            block = cols(mats[name], c0, c1)
            if onehot is not None:
                block = np.eye(onehot, dtype=np.float32)[
                    block[:, 0].astype(np.int64)]
            labels.append(block)
        return MultiDataSet(feats, labels)

    next = next_batch

    def reset(self):
        for r in self.readers.values():
            r.reset()

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_batch()


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """reference: datasets/datavec/SequenceRecordReaderDataSetIterator.java.

    Two aligned sequence readers (features + labels), or one reader with a
    label column. Sequences in a batch are padded to the longest with
    feature/label masks (the reference's ALIGN_END/variable-length path)."""

    def __init__(self, features_reader, labels_reader=None, batch_size=8,
                 num_classes=None, regression=False, label_index=None):
        self.freader = features_reader
        self.lreader = labels_reader
        self.batch_size = int(batch_size)
        self.num_classes = num_classes
        self.regression = regression
        self.label_index = label_index
        self.freader.reset()
        if self.lreader:
            self.lreader.reset()

    def has_next(self):
        return self.freader.has_next()

    def next_batch(self):
        fseqs, lseqs = [], []
        while self.freader.has_next() and len(fseqs) < self.batch_size:
            fs = [[float(v) for v in row]
                  for row in self.freader.next_sequence()]
            if self.lreader is not None:
                ls = [[float(v) for v in row]
                      for row in self.lreader.next_sequence()]
            elif self.label_index is not None:
                li = self.label_index
                ls = [[row[li]] for row in fs]
                fs = [row[:li] + row[li + 1:] for row in fs]
            else:
                raise ValueError("Need labels_reader or label_index")
            fseqs.append(fs)
            lseqs.append(ls)
        B = len(fseqs)
        T = max(len(s) for s in fseqs)
        F = len(fseqs[0][0])
        x = np.zeros((B, T, F), np.float32)
        fmask = np.zeros((B, T), np.float32)
        if self.regression:
            L = len(lseqs[0][0])
            y = np.zeros((B, T, L), np.float32)
        else:
            y = np.zeros((B, T, self.num_classes), np.float32)
        lmask = np.zeros((B, T), np.float32)
        for i, (fs, ls) in enumerate(zip(fseqs, lseqs)):
            x[i, :len(fs)] = fs
            fmask[i, :len(fs)] = 1.0
            for t, lab in enumerate(ls):
                if self.regression:
                    y[i, t] = lab
                else:
                    y[i, t, int(lab[0])] = 1.0
            lmask[i, :len(ls)] = 1.0
        return DataSet(x, y, fmask, lmask)

    def reset(self):
        self.freader.reset()
        if self.lreader:
            self.lreader.reset()

    def batch(self):
        return self.batch_size
