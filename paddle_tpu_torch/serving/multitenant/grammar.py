"""Grammar-constrained decoding: JSON-schema / regex -> token FSM
(counterpart of ``paddle_tpu/serving/multitenant/grammar.py``, host-side
numpy, kept as the port's own copy).

Outlines-style construction (Willard & Louf, "Efficient Guided Generation
for Large Language Models"): a regular expression is compiled to a
character-level DFA, then lifted to a TOKEN-level FSM against the serving
vocabulary — state ``s`` admits token ``t`` iff walking ``t``'s characters
from ``s`` stays inside the live DFA.  The engine keeps one FSM state per
constrained request and, each step, applies the state's precomputed
``allowed [V]`` boolean mask inside the batched sampler of the step
(``make_masked_batched_sampler``) — schema-valid output becomes a per-row
property of the one shared decode program instead of a second engine.

The regex dialect is the practical subset JSON grammars need: literals,
escapes (``\\d \\w \\s`` + escaped specials), character classes with
ranges and negation, ``.``, ``* + ?``, bounded ``{m}``/``{m,n}``/
``{m,}``, alternation and groups.  :func:`json_schema_to_regex` lowers a
JSON-schema subset (object/array/string/integer/number/boolean/null/enum,
properties emitted in declaration order, compact separators) onto it, so
``compile_json_schema(schema, vocab, eos)`` guarantees every completed
row parses as schema-valid JSON.

EOS semantics: the EOS token is allowed exactly in ACCEPTING states (the
match is complete there), so a constrained row can only stop on a fully
valid document; :class:`~.engine.MultiTenantEngine` defaults the row's
``eos_token_id`` to the FSM's.
"""

from __future__ import annotations

import json

import numpy as np

#: hard cap on discovered token-FSM states — a loud failure beats an
#: unbounded subset construction on a pathological pattern
MAX_STATES = 20000

_EPS = None  # epsilon edge marker in the NFA

_CLASSES = {
    "d": (False, frozenset("0123456789")),
    "w": (False, frozenset(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")),
    "s": (False, frozenset(" \t\n\r\f\v")),
    "D": (True, frozenset("0123456789")),
    "W": (True, frozenset(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")),
    "S": (True, frozenset(" \t\n\r\f\v")),
}

_ESCAPABLE = frozenset("\\.^$*+?{}[]()|/-\"'")


# ---------------------------------------------------------------- regex AST
class _Parser:
    """Recursive-descent regex -> AST.  Nodes: ('lit', matcher),
    ('cat', [..]), ('alt', [..]), ('rep', node, m, n|None) where a
    matcher is ``(negated, frozenset_of_chars)``."""

    def __init__(self, pattern):
        self.p = pattern
        self.i = 0

    def error(self, msg):
        raise ValueError(f"regex error at {self.i} in {self.p!r}: {msg}")

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self):
        c = self.peek()
        if c is None:
            self.error("unexpected end of pattern")
        self.i += 1
        return c

    def parse(self):
        node = self.alt()
        if self.i != len(self.p):
            self.error(f"unexpected {self.p[self.i]!r}")
        return node

    def alt(self):
        branches = [self.cat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def cat(self):
        items = []
        while self.peek() is not None and self.peek() not in "|)":
            items.append(self.repeat())
        if not items:
            return ("cat", [])      # empty branch: matches ""
        return items[0] if len(items) == 1 else ("cat", items)

    def repeat(self):
        node = self.atom()
        while True:
            c = self.peek()
            if c == "*":
                self.take()
                node = ("rep", node, 0, None)
            elif c == "+":
                self.take()
                node = ("rep", node, 1, None)
            elif c == "?":
                self.take()
                node = ("rep", node, 0, 1)
            elif c == "{":
                self.take()
                m = self._int()
                n = m
                if self.peek() == ",":
                    self.take()
                    n = self._int() if self.peek() != "}" else None
                if self.take() != "}":
                    self.error("expected '}'")
                if n is not None and n < m:
                    self.error(f"bad bound {{{m},{n}}}")
                node = ("rep", node, m, n)
            else:
                return node

    def _int(self):
        ds = ""
        while self.peek() is not None and self.peek().isdigit():
            ds += self.take()
        if not ds:
            self.error("expected integer")
        return int(ds)

    def atom(self):
        c = self.take()
        if c == "(":
            node = self.alt()
            if self.take() != ")":
                self.error("expected ')'")
            return node
        if c == "[":
            return ("lit", self._char_class())
        if c == ".":
            return ("lit", (True, frozenset("\n")))    # any but newline
        if c == "\\":
            return ("lit", self._escape())
        if c in "*+?{}|)":
            self.error(f"dangling {c!r}")
        return ("lit", (False, frozenset(c)))

    def _escape(self):
        e = self.take()
        if e in _CLASSES:
            return _CLASSES[e]
        if e == "n":
            return (False, frozenset("\n"))
        if e == "t":
            return (False, frozenset("\t"))
        if e == "r":
            return (False, frozenset("\r"))
        if e in _ESCAPABLE:
            return (False, frozenset(e))
        self.error(f"unsupported escape \\{e}")

    def _char_class(self):
        neg = False
        if self.peek() == "^":
            self.take()
            neg = True
        chars = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                self.error("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            c = self.take()
            first = False
            if c == "\\":
                n, cs = self._escape()
                if n:
                    self.error("negated class escape inside [...]")
                chars |= cs
                continue
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.take()
                hi = self.take()
                if hi == "\\":
                    _, cs = self._escape()
                    hi = min(cs)
                if ord(hi) < ord(c):
                    self.error(f"bad range {c}-{hi}")
                chars |= {chr(o) for o in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        return (neg, frozenset(chars))


# ------------------------------------------------------------- NFA / DFA
class _NFA:
    """Thompson construction over the AST.  Edges: node -> list of
    (matcher | None, target); matcher None is epsilon."""

    def __init__(self, ast):
        self.edges = []
        self.start = self._node()
        self.accept = self._node()
        self._build(ast, self.start, self.accept)

    def _node(self):
        self.edges.append([])
        return len(self.edges) - 1

    def _edge(self, a, b, matcher=_EPS):
        self.edges[a].append((matcher, b))

    def _build(self, ast, s, a):
        kind = ast[0]
        if kind == "lit":
            self._edge(s, a, ast[1])
        elif kind == "cat":
            cur = s
            for i, item in enumerate(ast[1]):
                nxt = a if i == len(ast[1]) - 1 else self._node()
                self._build(item, cur, nxt)
                cur = nxt
            if not ast[1]:
                self._edge(s, a)
        elif kind == "alt":
            for branch in ast[1]:
                bs, ba = self._node(), self._node()
                self._edge(s, bs)
                self._build(branch, bs, ba)
                self._edge(ba, a)
        elif kind == "rep":
            _, inner, m, n = ast
            cur = s
            for _ in range(m):              # mandatory copies
                nxt = self._node()
                self._build(inner, cur, nxt)
                cur = nxt
            if n is None:                   # x{m,}: Kleene tail
                ls, la = self._node(), self._node()
                self._edge(cur, ls)
                self._build(inner, ls, la)
                self._edge(la, ls)
                self._edge(cur, a)
                self._edge(la, a)
            else:
                for _ in range(n - m):      # optional copies
                    nxt = self._node()
                    self._build(inner, cur, nxt)
                    self._edge(cur, a)
                    cur = nxt
                self._edge(cur, a)
        else:  # pragma: no cover - parser emits only the kinds above
            raise AssertionError(kind)

    def closure(self, states):
        out = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for matcher, t in self.edges[s]:
                if matcher is _EPS and t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    def move(self, states, ch):
        out = set()
        for s in states:
            for matcher, t in self.edges[s]:
                if matcher is _EPS:
                    continue
                neg, chars = matcher
                if (ch in chars) != neg:
                    out.add(t)
        return self.closure(out) if out else None


class CompiledGrammar:
    """The token-level FSM the engine walks (one integer state per
    constrained request).  Built lazily over token-level reachability:
    only states an actual generation can visit are materialized.

    - ``start`` — initial state id;
    - ``allowed(state)`` — ``np.bool_ [V]`` mask of legal next tokens
      (EOS legal iff the state is accepting);
    - ``advance(state, token_id)`` — next state (``None`` for EOS / an
      illegal token);
    - ``is_final(state)`` — the matched prefix is a complete document.
    """

    def __init__(self, pattern, vocab, eos_token_id):
        if eos_token_id is None:
            raise ValueError("a grammar needs an eos_token_id: EOS is how "
                             "a constrained row says 'document complete'")
        self.pattern = str(pattern)
        self.vocab = list(vocab)
        self.vocab_size = len(self.vocab)
        self.eos_token_id = int(eos_token_id)
        if not 0 <= self.eos_token_id < self.vocab_size:
            raise ValueError(f"eos_token_id {eos_token_id} outside the "
                             f"{self.vocab_size}-token vocab")
        self._nfa = _NFA(_Parser(self.pattern).parse())
        # one grammar may be shared by many requests across several engine
        # scheduler threads (cluster replicas): lazy expansion is locked
        import threading

        self._lock = threading.RLock()
        self._char_trans = {}           # frozenset -> {ch -> frozenset|None}
        self._ids = {}                  # frozenset -> dense state id
        self._sets = []                 # dense id -> frozenset
        self._tok_trans = []            # dense id -> {tok -> dense id}
        self._masks = []                # dense id -> np.bool_ [V]
        self._final = []                # dense id -> bool
        # dead-end pruning: a token is only legal when its walk ends in a
        # LIVE char-DFA state (an accepting state stays reachable through
        # characters the vocab can actually spell).  Without this, a mask
        # could admit a token whose continuation no vocab token covers and
        # strand the row mid-document — masks are one-token lookahead.
        self._alphabet = sorted({ch for i, s in enumerate(self.vocab)
                                 if i != self.eos_token_id for ch in s})
        self._live = self._compute_live()
        self.start = self._intern(self._nfa.closure({self._nfa.start}))
        if self._sets[self.start] not in self._live:
            raise ValueError(
                f"grammar {self.pattern!r} has no completion spellable in "
                "this vocabulary (missing characters?)")

    def _compute_live(self):
        """Explore the full char-DFA over the vocab alphabet, then walk
        the edges backwards from the accepting states: the surviving set
        is every state from which a complete match is still spellable."""
        start = self._nfa.closure({self._nfa.start})
        seen = {start}
        order = [start]
        back = {}                       # state -> set of predecessors
        i = 0
        while i < len(order):
            cur = order[i]
            i += 1
            if len(seen) > MAX_STATES:
                raise ValueError(
                    f"grammar {self.pattern!r} exceeded {MAX_STATES} "
                    "char-DFA states; simplify the pattern")
            for ch in self._alphabet:
                nxt = self._char_step(cur, ch)
                if nxt is None:
                    continue
                back.setdefault(nxt, set()).add(cur)
                if nxt not in seen:
                    seen.add(nxt)
                    order.append(nxt)
        live = {s for s in seen if self._nfa.accept in s}
        stack = list(live)
        while stack:
            s = stack.pop()
            for p in back.get(s, ()):
                if p not in live:
                    live.add(p)
                    stack.append(p)
        return live

    # ------------------------------------------------------------ internals
    def _intern(self, nfa_set):
        sid = self._ids.get(nfa_set)
        if sid is not None:
            return sid
        if len(self._sets) >= MAX_STATES:
            raise ValueError(
                f"grammar {self.pattern!r} exceeded {MAX_STATES} token-FSM "
                "states; simplify the pattern (tighter bounds on {m,n} "
                "repetitions usually do it)")
        sid = len(self._sets)
        self._ids[nfa_set] = sid
        self._sets.append(nfa_set)
        self._tok_trans.append(None)    # computed lazily
        self._masks.append(None)
        self._final.append(self._nfa.accept in nfa_set)
        return sid

    def _char_step(self, nfa_set, ch):
        row = self._char_trans.setdefault(nfa_set, {})
        if ch not in row:
            row[ch] = self._nfa.move(nfa_set, ch)
        return row[ch]

    def _expand(self, sid):
        if self._tok_trans[sid] is not None:
            return
        with self._lock:
            self._expand_locked(sid)

    def _expand_locked(self, sid):
        if self._tok_trans[sid] is not None:
            return
        trans = {}
        mask = np.zeros((self.vocab_size,), np.bool_)
        src = self._sets[sid]
        for tok, s in enumerate(self.vocab):
            if tok == self.eos_token_id or not s:
                continue            # EOS handled below; empty tokens never
            cur = src
            for ch in s:
                cur = self._char_step(cur, ch)
                if cur is None:
                    break
            if cur is not None and cur in self._live:
                trans[tok] = self._intern(cur)
                mask[tok] = True
        mask[self.eos_token_id] = self._final[sid]
        # masks first, the trans dict last: _tok_trans doubles as the
        # "expanded" flag the unlocked fast path reads
        self._masks[sid] = mask
        self._tok_trans[sid] = trans

    # ----------------------------------------------------------------- api
    def allowed(self, state):
        self._expand(state)
        mask = self._masks[state]
        if not mask.any():
            # char-liveness says a completion is spellable, but no single
            # vocab TOKEN tiles the next step (pathological vocabs only —
            # BPE vocabs carry all single bytes).  Fail the request loudly
            # instead of letting an unmasked sampler emit junk.
            raise ValueError(
                f"grammar {self.pattern!r} reached a state no vocab token "
                "can continue; the vocabulary cannot tile this pattern")
        return mask

    def advance(self, state, token_id):
        self._expand(state)
        return self._tok_trans[state].get(int(token_id))

    def advance_seq(self, state, token_ids):
        """Fold :meth:`advance` over already-emitted tokens — how a
        re-admitted request (engine restart, cluster failover) resumes
        its grammar state from prompt + tokens-so-far."""
        for t in token_ids:
            if int(t) == self.eos_token_id:
                break
            state = self.advance(state, t)
            if state is None:
                raise ValueError(
                    f"token {int(t)} is not reachable in grammar "
                    f"{self.pattern!r} from the replayed state")
        return state

    def is_final(self, state):
        return self._final[state]

    def matches(self, token_ids):
        """Host-side oracle: do these generated ids (EOS-terminated or
        not) spell a COMPLETE document of the grammar?"""
        state = self.start
        for t in token_ids:
            if int(t) == self.eos_token_id:
                break
            state = self.advance(state, t)
            if state is None:
                return False
        return self.is_final(state)

    @property
    def num_states(self):
        """Token-FSM states materialized so far (lazy expansion)."""
        return len(self._sets)

    def __repr__(self):
        return (f"CompiledGrammar({self.pattern!r}, V={self.vocab_size}, "
                f"eos={self.eos_token_id}, states={self.num_states})")


# ------------------------------------------------------------ JSON schemas
def _regex_escape(text):
    return "".join("\\" + c if c in _ESCAPABLE and c != "'" else c
                   for c in str(text))


_STRING_CHARS = "[A-Za-z0-9_\\- ]"


def json_schema_to_regex(schema, max_string=16, max_items=4, max_digits=6):
    """Lower a JSON-schema subset to the regex dialect above (compact
    separators, no insignificant whitespace — what a sampler should emit).

    Supported: ``enum``/``const`` (JSON-encoded alternation), ``type`` in
    string (``pattern`` honored verbatim as the in-quote body,
    ``maxLength`` bounds the default body), integer, number, boolean,
    null, array (``items``/``minItems``/``maxItems``), object
    (``properties`` emitted in declaration order; every declared property
    is emitted — optionality would need backtracking budgets this
    lowering does not have, and is rejected loudly via ``required``
    mismatch)."""
    if not isinstance(schema, dict):
        raise TypeError(f"schema must be a dict, got {type(schema).__name__}")
    if "enum" in schema or "const" in schema:
        options = schema.get("enum", [schema.get("const")])
        return "(" + "|".join(
            _regex_escape(json.dumps(o, separators=(",", ":")))
            for o in options) + ")"
    t = schema.get("type")
    if t == "string":
        if "pattern" in schema:
            return f"\"({schema['pattern']})\""
        n = int(schema.get("maxLength", max_string))
        lo = int(schema.get("minLength", 0))
        return f"\"{_STRING_CHARS}{{{lo},{n}}}\""
    if t == "integer":
        return f"(-?(0|[1-9][0-9]{{0,{max_digits - 1}}}))"
    if t == "number":
        return (f"(-?(0|[1-9][0-9]{{0,{max_digits - 1}}})"
                f"(\\.[0-9]{{1,{max_digits}}})?)")
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = json_schema_to_regex(schema.get("items", {"type": "integer"}),
                                    max_string, max_items, max_digits)
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", max_items))
        if hi < 1 or hi < lo:
            raise ValueError(f"bad array bounds [{lo}, {hi}]")
        if lo == 0:
            return f"\\[({item}(,{item}){{0,{hi - 1}}})?\\]"
        return f"\\[{item}(,{item}){{{lo - 1},{hi - 1}}}\\]"
    if t == "object":
        props = schema.get("properties", {})
        if not props:
            return "\\{\\}"
        required = schema.get("required")
        if required is not None and set(required) != set(props):
            raise ValueError(
                "optional properties are not supported: every declared "
                f"property is emitted (properties {sorted(props)} vs "
                f"required {sorted(required)})")
        parts = []
        for name, sub in props.items():
            key = _regex_escape(json.dumps(str(name)))
            parts.append(f"{key}:" + json_schema_to_regex(
                sub, max_string, max_items, max_digits))
        return "\\{" + ",".join(parts) + "\\}"
    raise ValueError(f"unsupported schema: {schema!r}")


def compile_regex(pattern, vocab, eos_token_id):
    """Regex -> :class:`CompiledGrammar` over ``vocab`` (token id ->
    string).  Precompile ONCE per (grammar, vocab) and share across
    requests — the FSM is read-mostly (lazy state expansion is guarded by
    the engine's scheduler thread ownership)."""
    return CompiledGrammar(pattern, vocab, eos_token_id)


def compile_json_schema(schema, vocab, eos_token_id, **bounds):
    """JSON schema -> :class:`CompiledGrammar` (see
    :func:`json_schema_to_regex` for the supported subset)."""
    g = compile_regex(json_schema_to_regex(schema, **bounds), vocab,
                      eos_token_id)
    g.schema = schema
    return g
