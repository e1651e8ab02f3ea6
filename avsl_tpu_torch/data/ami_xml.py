"""AMI Meeting Corpus NITE-XML annotation parsing (L1).

A copy of ``avsl_tpu/data/ami_xml.py`` (host code; the port may not
import the JAX package): the same public names, and byte-identical
transcript and CSV files from the same XML.

Produces the same artifacts as the reference's annotation layer:

* ``process_transcripts``: ``segments.xml`` + ``words.xml`` -> per-speaker
  ``{meeting}-{speaker}.txt`` files of ``[start-end] text`` lines
  (reference: preprocess/transcript_process.py — punctuation attached
  without a space, truncated words dropped, disfluency markers skipped,
  ``<vocalsound type="laugh">`` emitted as the ``<laugh>`` token).
* ``disfluency_laughter_to_csv``: words + disfluency XML + the
  ``dsfl-types.xml`` ontology (19 AMI types) -> ``ami_laugh_markers.csv``
  with per-word ``disfluency_type`` in {laughter, <19 AMI types>[, fluent]}
  (reference: preprocess/disfluency_laughter_process.py).
* ``dialogue_acts_to_csv``: dialogue-act XML + ``da-types.xml`` /
  ``ap-types.xml`` -> ``ami_dialogue_acts.csv``, ``ami_adjacency_pairs.csv``
  and the joined ``ami_da_ap_laughter.csv``
  (reference: preprocess/dialogue_acts_process.py).

Unlike the reference (which re-walks the XML per producer), a single
:func:`parse_words_file` pass builds an ordered word table that all three
producers share.

Known deviation: the reference zeroes the 'laughter' label of a vocalsound
when an ontology is supplied but the element carries no disfluency
annotation (disfluency_laughter_process.py:196-199), silently dropping
un-annotated laughs; here laughter is preserved unless explicitly
re-annotated. Pass ``strict_reference=True`` to
:func:`disfluency_laughter_to_csv` (CLI: ``--strict_reference``) to get
the reference's exact row set for bit-parity diffs.
"""

from __future__ import annotations

import csv
import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

NITE_NS = "http://nite.sourceforge.net/"
NITE_ID = f"{{{NITE_NS}}}id"
NS = {"nite": NITE_NS}

# Speaker letter -> media channel names (reference preprocess/constants.py:45-66)
AMI_SPEAKERS: Dict[str, Dict[str, str]] = {
    "A": {"audio": "Headset-0", "video": "Closeup1"},
    "B": {"audio": "Headset-1", "video": "Closeup2"},
    "C": {"audio": "Headset-2", "video": "Closeup3"},
    "D": {"audio": "Headset-3", "video": "Closeup4"},
    "E": {"audio": "Headset-4", "video": "Closeup5"},
}

_WORD_NUM_RE = re.compile(r"words(?:x)?(\d+)")
_HREF_RANGE_RE = re.compile(r"#id\(([^)]+)\)\.\.id\(([^)]+)\)")
_HREF_SINGLE_RE = re.compile(r"#id\(([^)]+)\)")


@dataclass
class WordEntry:
    word_id: str
    order: int
    tag: str  # 'w' | 'vocalsound' | 'disfmarker' | ...
    text: str
    start: str
    end: str
    is_punct: bool = False
    is_trunc: bool = False
    vocal_type: str = ""


def _word_order(word_id: str) -> int:
    m = _WORD_NUM_RE.search(word_id)
    return int(m.group(1)) if m else -1


def _clean_text(text: Optional[str]) -> str:
    if not text:
        return ""
    return text.replace("&#39;", "'").replace("&quot;", '"')


def parse_words_file(words_file: str) -> Dict[str, WordEntry]:
    """One pass over a ``*.words.xml`` file -> ordered {id: WordEntry}."""
    root = ET.parse(words_file).getroot()
    table: Dict[str, WordEntry] = {}
    for elem in root.iter():
        word_id = elem.get(NITE_ID)
        if not word_id:
            continue
        tag = elem.tag.split("}")[-1]
        if tag not in ("w", "vocalsound", "disfmarker"):
            continue
        entry = WordEntry(
            word_id=word_id,
            order=_word_order(word_id),
            tag=tag,
            text=_clean_text(elem.text),
            start=elem.get("starttime", ""),
            end=elem.get("endtime", ""),
            is_punct=elem.get("punc") == "true",
            is_trunc=elem.get("trunc") == "true",
            vocal_type=elem.get("type", "") if tag == "vocalsound" else "",
        )
        if tag == "vocalsound" and entry.vocal_type == "laugh":
            entry.text = "<laugh>"
        table[word_id] = entry
    return table


def expand_href(href: str) -> List[str]:
    """Expand a NITE href (single id or id range) into the word-id list."""
    m = _HREF_RANGE_RE.search(href or "")
    if m:
        start_id, end_id = m.groups()
        start_num, end_num = _word_order(start_id), _word_order(end_id)
        prefix = _WORD_NUM_RE.split(start_id)[0]
        token = "wordsx" if "wordsx" in start_id else "words"
        return [f"{prefix}{token}{i}" for i in range(start_num, end_num + 1)]
    m = _HREF_SINGLE_RE.search(href or "")
    return [m.group(1)] if m else []


def _meeting_speaker_files(directory: str, suffix: str) -> List[Tuple[str, str, str]]:
    """List (meeting_id, speaker_id, path) for ``{m}.{s}.{suffix}`` files."""
    out = []
    if not os.path.isdir(directory):
        return out
    pat = re.compile(r"([^.]+)\.([^.]+)\." + re.escape(suffix) + r"$")
    for fname in sorted(os.listdir(directory)):
        m = pat.match(fname)
        if m:
            out.append((m.group(1), m.group(2), os.path.join(directory, fname)))
    return out


# ---------------------------------------------------------------------------
# 1. Transcript segments -> per-speaker txt
# ---------------------------------------------------------------------------


def process_transcript_files(
    segment_file: str, words_file: str, output_file: str
) -> int:
    """One (segments.xml, words.xml) pair -> ``[start-end] text`` lines.

    Returns the number of lines written.
    """
    words = parse_words_file(words_file)
    seg_root = ET.parse(segment_file).getroot()
    n = 0
    with open(output_file, "w", encoding="utf-8") as out:
        for segment in seg_root.iter("segment"):
            start = segment.get("transcriber_start")
            end = segment.get("transcriber_end")
            child = segment.find(".//nite:child", NS)
            if child is None:
                continue
            ids = expand_href(child.get("href", ""))
            entries = [
                words[i]
                for i in ids
                if i in words and words[i].tag != "disfmarker" and not words[i].is_trunc
            ]
            entries = [e for e in entries if e.text]
            entries.sort(key=lambda e: e.order)
            pieces: List[str] = []
            for e in entries:
                if e.is_punct and pieces:
                    pieces[-1] += e.text  # attach punctuation without space
                else:
                    pieces.append(e.text)
            if pieces:
                out.write(f"[{start}-{end}] {' '.join(pieces)}\n")
                n += 1
    return n


def process_transcripts(input_dir: str, output_dir: str) -> List[str]:
    """All meetings/speakers: ``{input}/segments`` + ``{input}/words`` ->
    ``{output}/{meeting}-{speaker}.txt``. Returns written paths."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for meeting, speaker, seg_path in _meeting_speaker_files(
        os.path.join(input_dir, "segments"), "segments.xml"
    ):
        words_path = os.path.join(input_dir, "words", f"{meeting}.{speaker}.words.xml")
        if not os.path.exists(words_path):
            continue
        out_path = os.path.join(output_dir, f"{meeting}-{speaker}.txt")
        process_transcript_files(seg_path, words_path, out_path)
        written.append(out_path)
    return written


# ---------------------------------------------------------------------------
# 2. Disfluency / laughter markers CSV
# ---------------------------------------------------------------------------


def load_disfluency_types(dsfl_types_file: str) -> Dict[str, str]:
    """``dsfl-types.xml`` ontology -> {nite id: type name} (19 AMI types)."""
    root = ET.parse(dsfl_types_file).getroot()
    out = {}
    for elem in root.iter():
        if elem.tag.split("}")[-1] == "dsfl-type":
            tid, name = elem.get(NITE_ID), elem.get("name")
            if tid and name:
                out[tid] = name
    return out


def _word_disfluency_map(disfluency_file: str) -> Dict[str, str]:
    """disfluency.xml -> {word_id: dsfl type id}."""
    out: Dict[str, str] = {}
    root = ET.parse(disfluency_file).getroot()
    for dsfl in root.iter():
        if dsfl.tag.split("}")[-1] != "dsfl":
            continue
        type_ptr = dsfl.find('.//nite:pointer[@role="dsfl-type"]', NS)
        if type_ptr is None:
            continue
        ids = _HREF_SINGLE_RE.search(type_ptr.get("href", ""))
        if not ids:
            continue
        type_id = ids.group(1)
        for child in dsfl.findall(".//nite:child", NS):
            for word_id in expand_href(child.get("href", "")):
                out[word_id] = type_id
    return out


def disfluency_laughter_to_csv(
    input_dir: str,
    output_dir: str,
    disfluency_dir: Optional[str] = None,
    dsfl_types_file: Optional[str] = None,
    include_fluent: bool = False,
    strict_reference: bool = False,
) -> str:
    """Emit ``ami_laugh_markers.csv`` with columns
    [meeting_id, speaker_id, word, start_time, end_time, disfluency_type].

    Laughter rows keep type 'laughter'; annotated words get their ontology
    type name; fluent words are included only if ``include_fluent`` or when
    no ontology is supplied (reference default behavior).

    ``strict_reference=True`` reproduces the reference's row set
    bit-for-bit (reference disfluency_laughter_process.py:180-214) so
    marker CSVs can be diffed row-identical against reference-built ones.
    Two documented deviations flip back in this mode:

    * with an ontology supplied, the lookup OVERWRITES the default label
      (reference :196-199: ``dsfl_types.get(word_to_disfluency.get(id,
      ''), '')``) — so un-annotated laughs AND fluent words get the empty
      type and are dropped, where the default mode preserves laughter;
    * punctuation ``w`` elements are not filtered (the reference has no
      punc check in this producer) — they surface only if annotated.
    """
    os.makedirs(output_dir, exist_ok=True)
    dsfl_types = load_disfluency_types(dsfl_types_file) if dsfl_types_file else None
    csv_path = os.path.join(output_dir, "ami_laugh_markers.csv")
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["meeting_id", "speaker_id", "word", "start_time", "end_time", "disfluency_type"]
        )
        for meeting, speaker, words_path in _meeting_speaker_files(
            os.path.join(input_dir, "words"), "words.xml"
        ):
            word_to_dsfl: Dict[str, str] = {}
            if disfluency_dir:
                dpath = os.path.join(disfluency_dir, f"{meeting}.{speaker}.disfluency.xml")
                if os.path.exists(dpath):
                    word_to_dsfl = _word_disfluency_map(dpath)
            for entry in parse_words_file(words_path).values():
                if entry.tag == "w":
                    if not strict_reference and (entry.is_punct or not entry.text):
                        continue
                    dtype = "fluent"
                elif entry.tag == "vocalsound" and entry.vocal_type == "laugh":
                    dtype = "laughter"
                else:
                    continue
                if strict_reference:
                    if dsfl_types is not None:
                        tid = word_to_dsfl.get(entry.word_id, "")
                        dtype = dsfl_types.get(tid, "")
                    if not dtype:
                        continue
                else:
                    if dsfl_types is not None and entry.word_id in word_to_dsfl:
                        dtype = dsfl_types.get(word_to_dsfl[entry.word_id], dtype)
                    if dtype == "fluent" and dsfl_types is not None and not include_fluent:
                        continue
                writer.writerow(
                    [meeting, speaker, entry.text, entry.start, entry.end, dtype]
                )
    return csv_path


# ---------------------------------------------------------------------------
# 3. Dialogue acts / adjacency pairs CSVs
# ---------------------------------------------------------------------------


def _load_ontology(path: str, tag: str) -> Dict[str, Dict[str, str]]:
    root = ET.parse(path).getroot()
    out: Dict[str, Dict[str, str]] = {}

    def walk(elem, category: str):
        for child in elem:
            short = child.tag.split("}")[-1]
            if short != tag:
                continue
            tid = child.get(NITE_ID)
            if tid:
                out[tid] = {
                    "name": child.get("name", ""),
                    "gloss": child.get("gloss", ""),
                    "category": category,
                }
                walk(child, child.get("name", category))

    walk(root, root.get("name", ""))
    return out


def load_da_types(path: str) -> Dict[str, Dict[str, str]]:
    """``da-types.xml`` -> {id: {name, gloss, category}} (nested classes)."""
    return _load_ontology(path, "da-type")


def load_ap_types(path: str) -> Dict[str, str]:
    """``ap-types.xml`` -> {id: gloss}."""
    root = ET.parse(path).getroot()
    out = {}
    for elem in root.iter():
        if elem.tag.split("}")[-1] == "ap-type":
            tid = elem.get(NITE_ID)
            if tid:
                out[tid] = elem.get("gloss", elem.get("name", ""))
    return out


def dialogue_acts_to_csv(
    input_dir: str,
    output_dir: str,
    dialogue_acts_dir: Optional[str] = None,
    da_types_file: Optional[str] = None,
    ap_types_file: Optional[str] = None,
    include_adjacency_pairs: bool = True,
) -> Dict[str, str]:
    """Emit dialogue-act, adjacency-pair, and joined CSVs.

    Schemas match the reference (dialogue_acts_process.py:86,132-134):
    per-word DA rows with type name/gloss/category + event_type
    (fluent | laughter | vocalsound); AP rows with source/target dact refs;
    joined on (meeting_id, speaker_id, dact_id) left-merge.
    """
    import pandas as pd

    os.makedirs(output_dir, exist_ok=True)
    dialogue_acts_dir = dialogue_acts_dir or os.path.join(input_dir, "dialogueActs")
    da_types = load_da_types(da_types_file) if da_types_file else {}
    ap_types = load_ap_types(ap_types_file) if ap_types_file else {}

    da_csv = os.path.join(output_dir, "ami_dialogue_acts.csv")
    meetings = set()
    with open(da_csv, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["meeting_id", "speaker_id", "dact_id", "word", "start_time", "end_time",
             "dialogue_act_type", "dialogue_act_gloss", "dialogue_act_category",
             "event_type"]
        )
        for meeting, speaker, da_path in _meeting_speaker_files(
            dialogue_acts_dir, "dialog-act.xml"
        ):
            meetings.add(meeting)
            words_path = os.path.join(input_dir, "words", f"{meeting}.{speaker}.words.xml")
            if not os.path.exists(words_path):
                continue
            words = parse_words_file(words_path)
            root = ET.parse(da_path).getroot()
            for dact in root.iter():
                if dact.tag.split("}")[-1] != "dact":
                    continue
                dact_id = dact.get(NITE_ID)
                type_info = {"name": "", "gloss": "", "category": ""}
                ptr = dact.find('.//nite:pointer[@role="da-aspect"]', NS)
                if ptr is not None:
                    m = _HREF_SINGLE_RE.search(ptr.get("href", ""))
                    if m and m.group(1) in da_types:
                        type_info = da_types[m.group(1)]
                for child in dact.findall(".//nite:child", NS):
                    for word_id in expand_href(child.get("href", "")):
                        e = words.get(word_id)
                        if e is None or e.is_punct:
                            continue
                        if e.tag == "w":
                            text = "".join(e.text.split("_"))
                            event = "fluent"
                        elif e.tag == "vocalsound":
                            text = e.text if e.vocal_type == "laugh" else f"<{e.vocal_type or 'vocalsound'}>"
                            event = "laughter" if e.vocal_type == "laugh" else "vocalsound"
                        else:
                            continue
                        if not text:
                            continue
                        writer.writerow(
                            [meeting, speaker, dact_id, text, e.start, e.end,
                             type_info["name"], type_info["gloss"],
                             type_info["category"], event]
                        )

    out = {"dialogue_acts": da_csv}
    if not include_adjacency_pairs:
        return out

    ap_csv = os.path.join(output_dir, "ami_adjacency_pairs.csv")

    def dact_ref(href: str) -> Dict[str, str]:
        m = _HREF_SINGLE_RE.search(href or "")
        if not m:
            return {"meeting_id": "", "speaker_id": "", "dact_id": ""}
        dact_id = m.group(1)
        fname = (href or "").split("#")[0]
        fm = re.match(r"([^.]+)\.([^.]+)\.", os.path.basename(fname))
        return {
            "meeting_id": fm.group(1) if fm else "",
            "speaker_id": fm.group(2) if fm else "",
            "dact_id": dact_id,
        }

    with open(ap_csv, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["meeting_id", "pair_id", "pair_type", "pair_type_gloss",
             "source_meeting_id", "source_speaker_id", "source_dact_id",
             "target_meeting_id", "target_speaker_id", "target_dact_id"]
        )
        for meeting in sorted(meetings):
            ap_path = os.path.join(dialogue_acts_dir, f"{meeting}.adjacency-pairs.xml")
            if not os.path.exists(ap_path):
                continue
            root = ET.parse(ap_path).getroot()
            for pair in root.iter():
                if pair.tag.split("}")[-1] != "adjacency-pair":
                    continue
                pair_id = pair.get(NITE_ID)
                type_id, gloss = "", ""
                ptr = pair.find('.//nite:pointer[@role="type"]', NS)
                if ptr is not None:
                    m = _HREF_SINGLE_RE.search(ptr.get("href", ""))
                    if m:
                        type_id = m.group(1)
                        gloss = ap_types.get(type_id, "")
                src = pair.find('.//nite:pointer[@role="source"]', NS)
                tgt = pair.find('.//nite:pointer[@role="target"]', NS)
                s = dact_ref(src.get("href", "") if src is not None else "")
                t = dact_ref(tgt.get("href", "") if tgt is not None else "")
                writer.writerow(
                    [meeting, pair_id, type_id, gloss,
                     s["meeting_id"], s["speaker_id"], s["dact_id"],
                     t["meeting_id"], t["speaker_id"], t["dact_id"]]
                )
    out["adjacency_pairs"] = ap_csv

    # joined CSV (left merge on meeting/speaker/dact)
    da_df = pd.read_csv(da_csv)
    ap_df = pd.read_csv(ap_csv)
    ap_df = ap_df.rename(
        columns={"source_dact_id": "dact_id", "source_speaker_id": "speaker_id"}
    ).drop(columns=["source_meeting_id", "target_meeting_id"])
    joined = pd.merge(da_df, ap_df, on=["meeting_id", "speaker_id", "dact_id"], how="left")
    joined_csv = os.path.join(output_dir, "ami_da_ap_laughter.csv")
    joined.to_csv(joined_csv, index=False)
    out["joined"] = joined_csv
    return out
