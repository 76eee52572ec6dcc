"""WordVectorSerializer: persist/load word vectors.

Ref: deeplearning4j-nlp models/embeddings/loader/WordVectorSerializer.java
(2824 LoC: word2vec C text/binary formats, compressed archives, full-model
zip). Provided here:

- word2vec C **text** format (writeWordVectors / loadTxtVectors parity)
- word2vec C **binary** format — the Google News ``.bin`` layout the
  reference's ``loadGoogleModel(file, binary=true)`` reads: ASCII header
  ``"V D\\n"``, then per word the chars up to ``' '`` followed by D
  little-endian float32s and an optional ``'\\n'``
- transparent gzip for both (``.gz`` suffix — loadGoogleModel's
  GZIPInputStream path)
- a full-model zip bundle (vocab + syn0/syn1/syn1neg) preserving HS/NS
  output weights for continued training (lookup-table round-trip)
"""

from __future__ import annotations

import gzip
import io
import json
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord, build_huffman


def _is_gz(path) -> bool:
    return str(path).endswith(".gz")


def _infer_binary(path) -> bool:
    """.bin / .bin.gz → binary; everything else text (override with the
    explicit ``binary=`` argument, as the reference's loadGoogleModel
    flag does)."""
    name = str(path)
    if name.endswith(".gz"):
        name = name[:-3]
    return name.endswith(".bin")


class WordVectorSerializer:
    @staticmethod
    def write_word2vec_format(table: InMemoryLookupTable, path,
                              binary: Optional[bool] = None) -> None:
        """word2vec C format, text (default) or binary (.bin); ``.gz``
        paths are gzip-compressed (ref: writeWordVectors /
        WordVectorSerializer.writeBinary)."""
        if binary is None:
            binary = _infer_binary(path)
        opener = gzip.open if _is_gz(path) else open
        if binary:
            with opener(path, "wb") as f:
                f.write(f"{len(table.vocab)} {table.vector_length}\n"
                        .encode("utf-8"))
                for vw in table.vocab.vocab_words():
                    f.write(vw.word.encode("utf-8") + b" ")
                    f.write(np.asarray(table.syn0[vw.index],
                                       dtype="<f4").tobytes())
                    f.write(b"\n")
            return
        lines = [f"{len(table.vocab)} {table.vector_length}"]
        for vw in table.vocab.vocab_words():
            vec = " ".join(f"{v:.6f}" for v in table.syn0[vw.index])
            lines.append(f"{vw.word} {vec}")
        with opener(path, "wb") as f:
            f.write(("\n".join(lines) + "\n").encode("utf-8"))

    @staticmethod
    def read_word2vec_format(path, binary: Optional[bool] = None
                             ) -> InMemoryLookupTable:
        """Load word2vec C text or binary (= the reference's
        loadGoogleModel / loadTxtVectors), gzip-transparent."""
        if binary is None:
            binary = _infer_binary(path)
        opener = gzip.open if _is_gz(path) else open
        if binary:
            with opener(path, "rb") as f:
                return WordVectorSerializer._parse_binary_stream(
                    io.BufferedReader(f) if not isinstance(
                        f, io.BufferedReader) else f)
        with opener(path, "rb") as f:
            text = f.read().decode("utf-8").splitlines()
        header = text[0].split()
        v, d = int(header[0]), int(header[1])
        cache = VocabCache()
        vecs = np.zeros((v, d), dtype=np.float32)
        for i, line in enumerate(text[1:1 + v]):
            parts = line.rstrip().split(" ")
            word, vals = parts[0], parts[1:]
            cache.add(VocabWord(word, 1.0))
            vecs[i] = np.array([float(x) for x in vals], dtype=np.float32)
        cache.total_word_count = float(v)
        build_huffman(cache)
        table = InMemoryLookupTable(cache, d)
        table.syn0 = vecs
        return table

    @staticmethod
    def _parse_binary_stream(f) -> InMemoryLookupTable:
        """Stream-parse record by record (the reference's loadGoogleModel
        reads the same way): O(1) extra memory beyond the vector matrix —
        a Google News-scale .bin must not be duplicated wholesale in RAM,
        and a .gz input decompresses incrementally."""
        header = bytearray()
        while not header.endswith(b"\n"):
            b = f.read(1)
            if not b:
                raise ValueError("truncated word2vec binary header")
            header += b
        v, d = (int(x) for x in header.split())
        cache = VocabCache()
        vecs = np.empty((v, d), dtype=np.float32)
        vec_bytes = 4 * d
        for i in range(v):
            word = bytearray()
            ch = f.read(1)
            # skip the newline the original C tool writes after each
            # vector (some writers don't)
            while ch in (b"\n", b"\r"):
                ch = f.read(1)
            while ch != b" ":
                if not ch:
                    raise ValueError(f"truncated record {i}")
                word += ch
                ch = f.read(1)
            buf = f.read(vec_bytes)
            if len(buf) != vec_bytes:
                raise ValueError(f"truncated vector for record {i}")
            vecs[i] = np.frombuffer(buf, dtype="<f4", count=d)
            cache.add(VocabWord(word.decode("utf-8"), 1.0))
        cache.total_word_count = float(v)
        build_huffman(cache)
        table = InMemoryLookupTable(cache, d)
        table.syn0 = vecs
        return table

    @staticmethod
    def write_full_model(table: InMemoryLookupTable, path) -> None:
        """Zip bundle: vocab.json + weights.npz (syn0/syn1/syn1neg) —
        the analog of the reference's full-model format that preserves
        HS/NS output weights for continued training."""
        path = Path(path)
        vocab_meta = [{"word": w.word, "count": w.count,
                       "codes": w.codes, "points": w.points}
                      for w in table.vocab.vocab_words()]
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("vocab.json", json.dumps(
                {"vector_length": table.vector_length, "words": vocab_meta}))
            import io
            buf = io.BytesIO()
            np.savez(buf, syn0=table.syn0, syn1=table.syn1,
                     syn1neg=table.syn1neg)
            zf.writestr("weights.npz", buf.getvalue())

    @staticmethod
    def read_full_model(path) -> InMemoryLookupTable:
        import io
        with zipfile.ZipFile(Path(path), "r") as zf:
            meta = json.loads(zf.read("vocab.json"))
            npz = np.load(io.BytesIO(zf.read("weights.npz")))
        cache = VocabCache()
        for m in meta["words"]:
            vw = VocabWord(m["word"], m["count"])
            vw.codes, vw.points = m["codes"], m["points"]
            cache.add(vw)
        cache.total_word_count = float(
            sum(w.count for w in cache.vocab_words()))
        table = InMemoryLookupTable(cache, meta["vector_length"])
        table.syn0 = npz["syn0"]
        table.syn1 = npz["syn1"]
        table.syn1neg = npz["syn1neg"]
        return table
