"""Rows of TPC-H ``lineitem`` as ``dbgen`` writes ``lineitem.tbl``, made in
bulk with numpy from a seed.

Each row is the 16 columns of the TPC-H specification (revision 3), §1.4.1,
each followed by ``|``, then a newline. The value domains are those of §4.2.3:

- ``L_ORDERKEY``: the sparse order keys (8 of every 32: 1-7, 32-39, ...),
  1 to 7 lines an order, the orders in key order from the first;
- ``L_PARTKEY`` uniform over [1, 200,000 × SF]; ``L_SUPPKEY`` one of the
  part's four suppliers by the specification's formula over 10,000 × SF;
- ``L_LINENUMBER`` 1 to the order's line count; ``L_QUANTITY`` 1-50;
- ``L_EXTENDEDPRICE`` the quantity times the part's retail price
  ``(90000 + ((pk / 10) mod 20001) + 100 × (pk mod 1000)) / 100``;
- ``L_DISCOUNT`` 0.00-0.10 and ``L_TAX`` 0.00-0.08;
- ``O_ORDERDATE`` uniform over [1992-01-01, 1998-12-31 less 151 days];
  ship date the order date + 1-121 days, commit date + 30-90, receipt date
  the ship date + 1-30; ``L_RETURNFLAG`` R or A where the receipt date is
  on or before 1995-06-17, else N; ``L_LINESTATUS`` O where the ship date
  is after it, else F;
- ``L_SHIPINSTRUCT`` one of 4 and ``L_SHIPMODE`` one of 7, uniformly;
- ``L_COMMENT`` 10-43 characters cut at a random offset from a text pool
  of the grammar of §4.2.2.10.

What this generator sets itself is listed in ``ASSUMED``; the configuration
files repeat it.
"""

from __future__ import annotations

import numpy as np

ASSUMED = {
    "word_lists": "the nouns, verbs, adjectives, adverbs, prepositions, auxiliaries "
                  "and terminators of dbgen's dists.dss, each chosen uniformly (dbgen "
                  "weights them)",
    "grammar": "a sentence is a noun phrase, a verb phrase, an optional prepositional "
               "phrase and a terminator; the spec's sentence forms with two verb or "
               "prepositional phrases are left out",
    "text_pool_bytes": "4 MiB of grammar text a seed (dbgen: 300 MiB)",
    "comment_length": "uniform over [10, 43], dbgen's 0.4 and 1.6 times the mean of 27",
    "orders": "the first orders of the table, in key order, as dbgen writes them",
}

NOUNS = (
    "foxes ideas theodolites pinto@beans instructions dependencies excuses platelets "
    "asymptotes courts dolphins multipliers sauternes warthogs frets dinos attainments "
    "somas Tiresias patterns forges braids hockey@players frays warhorses dugouts "
    "notornis epitaphs pearls tithes waters orbits gifts sheaves depths sentiments "
    "decoys realms pains grouches escapades packages requests accounts deposits"
).split()
VERBS = (
    "sleep wake are cajole haggle nag use boost affix detect integrate maintain nod was "
    "lose sublate solve thrash promise engage hinder print x-ray breach eat grow impress "
    "mold poach serve run dazzle snooze doze unwind kindle play hang believe doubt").split()
ADJECTIVES = (
    "furious sly careful blithe quick fluffy slow quiet ruthless thin close dogged "
    "daring brave stealthy permanent enticing idle busy regular final ironic even "
    "bold silent pending special express unusual").split()
ADVERBS = (
    "sometimes always never furiously slyly carefully blithely quickly fluffily slowly "
    "quietly ruthlessly thinly closely doggedly daringly bravely stealthily permanently "
    "enticingly idly busily regularly finally ironically evenly boldly silently").split()
PREPOSITIONS = (
    "about above according@to across after against along alongside@of among around "
    "at atop before behind beneath beside besides between beyond by despite during "
    "except for from in@place@of inside instead@of into near of on outside over past "
    "since through throughout to toward under until up upon without with within").split()
AUXILIARIES = (
    "do may might shall will would can could should ought@to must will@have@to "
    "shall@have@to could@have@to should@have@to must@have@to need@to try@to").split()
TERMINATORS = (".", ";", ":", "?", "!", "--")
NOUNS, PREPOSITIONS, AUXILIARIES = ([w.replace("@", " ") for w in words]
                                    for words in (NOUNS, PREPOSITIONS, AUXILIARIES))

SHIP_INSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
SHIP_MODE = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")

START_DAY = (np.datetime64("1992-01-01") - np.datetime64("1970-01-01")).astype(int)
END_DAY = (np.datetime64("1998-12-31") - np.datetime64("1970-01-01")).astype(int)
CURRENT_DAY = (np.datetime64("1995-06-17") - np.datetime64("1970-01-01")).astype(int)
POOL_BYTES = 4 << 20
COMMENT_MIN, COMMENT_MAX = 10, 43
MEAN_ROW_BYTES = 118  # under the mean at SF 1 (124.5), so one pass suffices


def _words(rng, words, n):
    return [words[i] for i in rng.integers(0, len(words), n)]


def text_pool(rng: np.random.Generator, n_bytes: int = POOL_BYTES) -> np.ndarray:
    """``n_bytes`` of the grammar's sentences, separated by spaces."""
    out, size = [], 0
    while size < n_bytes:
        n = 4096
        adj1, adj2 = _words(rng, ADJECTIVES, n), _words(rng, ADJECTIVES, n)
        adv1, adv2 = _words(rng, ADVERBS, n), _words(rng, ADVERBS, n)
        noun1, noun2 = _words(rng, NOUNS, n), _words(rng, NOUNS, n)
        verb, aux = _words(rng, VERBS, n), _words(rng, AUXILIARIES, n)
        prep, term = _words(rng, PREPOSITIONS, n), _words(rng, TERMINATORS, n)
        np_form, vp_form, pp = (rng.integers(0, 4, n), rng.integers(0, 4, n),
                                rng.integers(0, 2, n))
        np2_form = rng.integers(0, 4, n)
        for i in range(n):
            def noun_phrase(form, noun):
                return (noun, f"{adj1[i]} {noun}", f"{adj1[i]}, {adj2[i]} {noun}",
                        f"{adv1[i]} {adj1[i]} {noun}")[form]
            verb_phrase = (verb[i], f"{aux[i]} {verb[i]}", f"{verb[i]} {adv2[i]}",
                           f"{aux[i]} {verb[i]} {adv2[i]}")[vp_form[i]]
            s = f"{noun_phrase(np_form[i], noun1[i])} {verb_phrase}"
            if pp[i]:
                s += f" {prep[i]} the {noun_phrase(np2_form[i], noun2[i])}"
            s += f"{term[i]} "
            out.append(s)
            size += len(s)
    return np.frombuffer("".join(out).encode()[:n_bytes], np.uint8)


def _digits(x: np.ndarray) -> np.ndarray:
    """The decimal digits of non-negative ``x``, left-aligned in as many
    columns as the largest needs, 0 past each number's last digit."""
    x = x.astype(np.int64)
    width = len(str(int(x.max()))) if x.size else 1
    right = np.stack([(x // 10 ** j) % 10 for j in range(width)], 1)  # units first
    n = np.ones_like(x)
    for j in range(1, width):
        n += x >= 10 ** j
    power = n[:, None] - 1 - np.arange(width)[None, :]
    digit = np.take_along_axis(right, np.maximum(power, 0), 1) + 48
    return np.where(power >= 0, digit, 0).astype(np.uint8)


def _cents(x: np.ndarray) -> np.ndarray:
    """``x`` hundredths as ``d.dd``, left-aligned, 0 past each number."""
    whole = _digits(x // 100)
    frac = x % 100
    out = np.zeros((len(x), whole.shape[1] + 3), np.uint8)
    out[:, :whole.shape[1]] = whole
    end = (whole != 0).sum(1)
    rows = np.arange(len(x))
    out[rows, end] = ord(".")
    out[rows, end + 1] = frac // 10 + 48
    out[rows, end + 2] = frac % 10 + 48
    return out


def _dates(days: np.ndarray) -> np.ndarray:
    """``YYYY-MM-DD`` of each day number (days since 1970-01-01)."""
    lo = int(days.min())
    span = np.arange(lo, int(days.max()) + 1).astype("datetime64[D]")
    table = np.datetime_as_string(span, unit="D").astype("S10")
    return np.frombuffer(table.tobytes(), np.uint8).reshape(-1, 10)[days - lo]


def _choice(rng, words, n):
    width = max(map(len, words))
    table = np.zeros((len(words), width), np.uint8)
    for i, w in enumerate(words):
        table[i, :len(w)] = np.frombuffer(w.encode(), np.uint8)
    return table[rng.integers(0, len(words), n)]


def rows(seed: int, n_bytes: int, scale_factor: float) -> np.ndarray:
    """At least ``n_bytes`` of whole ``lineitem.tbl`` rows, uint8."""
    rng = np.random.default_rng(seed)
    pool = text_pool(rng)
    n_orders = n_bytes // (4 * MEAN_ROW_BYTES) + 64
    parts = int(200_000 * scale_factor)
    supps = int(10_000 * scale_factor)

    index = np.arange(1, n_orders + 1, dtype=np.int64)
    orderkey = ((index >> 3) << 5) | (index & 7)
    lines = rng.integers(1, 8, n_orders)
    orderdate = rng.integers(START_DAY, END_DAY - 151 + 1, n_orders)
    n = int(lines.sum())
    orderkey, orderdate = np.repeat(orderkey, lines), np.repeat(orderdate, lines)
    first = np.repeat(np.cumsum(lines) - lines, lines)
    linenumber = np.arange(n) - first + 1

    partkey = rng.integers(1, parts + 1, n)
    supp_i = rng.integers(0, 4, n)
    suppkey = (partkey + supp_i * (supps // 4 + (partkey - 1) // supps)) % supps + 1
    quantity = rng.integers(1, 51, n)
    retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    discount = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    shipdate = orderdate + rng.integers(1, 122, n)
    commitdate = orderdate + rng.integers(30, 91, n)
    receiptdate = shipdate + rng.integers(1, 31, n)
    flag = np.where(receiptdate <= CURRENT_DAY,
                    np.where(rng.integers(0, 2, n) == 0, ord("R"), ord("A")), ord("N"))
    status = np.where(shipdate > CURRENT_DAY, ord("O"), ord("F"))
    clen = rng.integers(COMMENT_MIN, COMMENT_MAX + 1, n)
    coff = rng.integers(0, len(pool) - COMMENT_MAX, n)
    k = np.arange(COMMENT_MAX)[None, :]
    comment = np.where(k < clen[:, None], pool[coff[:, None] + k], 0).astype(np.uint8)

    fields = [
        _digits(orderkey), _digits(partkey), _digits(suppkey),
        _digits(linenumber), _digits(quantity),
        _cents(quantity * retail), _cents(discount), _cents(tax),
        flag.astype(np.uint8)[:, None], status.astype(np.uint8)[:, None],
        _dates(shipdate), _dates(commitdate), _dates(receiptdate),
        _choice(rng, SHIP_INSTRUCT, n), _choice(rng, SHIP_MODE, n), comment,
    ]
    width = sum(f.shape[1] + 1 for f in fields) + 1
    mat = np.zeros((n, width), np.uint8)
    col = 0
    for f in fields:
        mat[:, col:col + f.shape[1]] = f
        mat[:, col + f.shape[1]] = ord("|")
        col += f.shape[1] + 1
    mat[:, col] = ord("\n")
    return mat[mat != 0]


def chunks(seed: int, count: int, chunk_bytes: int, scale_factor: float) -> np.ndarray:
    """The first ``count × chunk_bytes`` bytes of the rows, cut into
    (count, chunk_bytes) uint8 chunks."""
    need = count * chunk_bytes
    data = rows(seed, need, scale_factor)
    if data.size < need:
        raise RuntimeError(f"generated {data.size} bytes, {need} needed")
    return data[:need].reshape(count, chunk_bytes)
