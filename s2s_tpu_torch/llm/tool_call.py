"""Prompted tool calling for local models.

One module covering the reference's ``LLM/tool_call/`` package
(``function_tool.py``, ``tool_prompt.py``, ``signature_from_schema.py``,
``function_call.py``): JSON-Schema -> Python-signature docstring prompts,
``<code>...</code>`` block extraction, tokenize/AST parsing of
``name(kwargs)`` with a regex fallback for malformed output, and schema
validation (drop undeclared args, error on missing required).
"""

from __future__ import annotations

import ast
import inspect
import io
import json
import logging
import re
import textwrap
import tokenize
from collections import OrderedDict
from typing import Any, Literal, Union

from pydantic import BaseModel

from s2s_tpu_torch.realtime.types import FunctionTool, FunctionToolCall, generate_id

logger = logging.getLogger(__name__)

ENTER_CODE = "<code>"
END_CODE = "</code>"

_POSITIONAL_RE = re.compile(r"^__arg_\d+__$")
_LENIENT_CALL_RE = re.compile(
    r"\b[A-Za-z_]\w*(?:\.[A-Za-z_]\w*)*\s*"
    r"\((?:[^()\"']+|\"(?:\\.|[^\"])*\"|'(?:\\.|[^'])*')*\)"
)

_JSON_TO_PY = {
    "string": str, "number": float, "boolean": bool, "integer": int,
    "object": dict, "array": list, "null": type(None),
}


# ── JSON-Schema -> inspect.Signature ─────────────────────────────────


def _dedupe(xs: list[Any]) -> list[Any]:
    out: list[Any] = []
    for x in xs:
        if x not in out:
            out.append(x)
    return out


def _annotation(spec: Any) -> Any:
    if not isinstance(spec, dict) or not spec:
        return Any
    if "const" in spec:
        return Literal[spec["const"]]
    if "enum" in spec:
        return Literal[tuple(spec["enum"])] if spec["enum"] else Any
    for key in ("anyOf", "oneOf"):
        if key in spec:
            variants = _dedupe([_annotation(s) for s in spec[key]])
            if not variants:
                return Any
            return variants[0] if len(variants) == 1 else Union[tuple(variants)]
    if "allOf" in spec:
        merged: dict[str, Any] = {}
        for sub in spec["allOf"]:
            merged.update(sub)
        return _annotation(merged)
    jt = spec.get("type")
    if jt is None:
        return Any
    if isinstance(jt, list):
        types = _dedupe([_JSON_TO_PY.get(t, Any) for t in jt])
        if not types:
            return Any
        return types[0] if len(types) == 1 else Union[tuple(types)]
    if jt == "array" and "items" in spec:
        return list[_annotation(spec["items"])]  # type: ignore[misc, valid-type]
    return _JSON_TO_PY.get(jt, Any)


def signature_from_schema(schema: Any) -> inspect.Signature:
    if not isinstance(schema, dict) or not schema:
        return inspect.Signature()
    props = schema.get("properties", {})
    required = set(schema.get("required", []))
    params = []
    for name, spec in props.items():
        has_default = isinstance(spec, dict) and "default" in spec
        if name in required and not has_default:
            default = inspect.Parameter.empty
        elif has_default:
            default = spec["default"]
        else:
            default = None
        params.append(
            inspect.Parameter(
                name, inspect.Parameter.POSITIONAL_OR_KEYWORD,
                default=default, annotation=_annotation(spec),
            )
        )
    # a schema may list an optional property before a required one; Python
    # signatures forbid non-default-after-default, so required params sort
    # first (stable within each group)
    params.sort(key=lambda p: p.default is not inspect.Parameter.empty)
    return inspect.Signature(params)


def tool_code_prompt(tool: FunctionTool, include_args_doc: bool = True) -> str:
    """Render one tool as a ``def name(sig):`` + docstring block."""
    sig = signature_from_schema(tool.parameters)
    doc = tool.description or ""
    if include_args_doc and isinstance(tool.parameters, dict):
        props = tool.parameters.get("properties", {})
        if props:
            lines = [
                f"{n}: {s.get('description', '') if isinstance(s, dict) else ''}" for n, s in props.items()
            ]
            doc += "\n\nArgs:\n" + textwrap.indent("\n".join(lines), "    ")
    doc = f'"""{doc}\n"""'
    return f"def {tool.name}{sig}:\n{textwrap.indent(doc, '    ')}"


# ── prompt section ───────────────────────────────────────────────────

_VOICE_RULES = """\
Rules:
- You may say one brief natural sentence before the tool call; for slow information tools, briefly say that you will check.
- For expression/background tools, always speak first. For requested expressions, use a short pattern like "Sure, here's my best <emotion>."; otherwise use a fitting empathetic sentence.
- Do not mention tags, functions, or tools. Keep prose outside tags brief, and do not claim tool results before a tool result is available.
- Use named arguments only; quote strings. Omit optional args instead of placeholder values like "random", "none", "", or null.
- Only one tool call may appear in a response."""

_TEXT_RULES = """\
Rules:
- Call a tool directly when it helps fulfill the request; no preamble sentence is required.
- Do not mention tags, functions, or tools in your prose, and do not claim tool results before a tool result is available.
- Use named arguments only; quote strings. Omit optional args instead of placeholder values like "random", "none", "", or null.
- Only one tool call may appear in a response."""


def build_tool_system_prompt(
    tools: list[FunctionTool],
    enter_code: str = ENTER_CODE,
    end_code: str = END_CODE,
    *,
    text_only: bool = False,
) -> str:
    """Tool-section of the system prompt; empty string when no tools."""
    if not tools:
        return ""
    blocks = "\n\n".join(tool_code_prompt(t) for t in tools)
    rules = _TEXT_RULES if text_only else _VOICE_RULES
    return (
        f"Available tools:\n\n{blocks}\n\n"
        f"To call a tool, put exactly one named-argument function call inside "
        f"{enter_code}...{end_code}:\n{enter_code}function_name(required_arg='value'){end_code}\n\n"
        f"{rules}"
    )


def build_block_regex(enter_code: str = ENTER_CODE, end_code: str = END_CODE) -> str:
    return f"{re.escape(enter_code)}.*?{re.escape(end_code)}"


# ── parsing model output ─────────────────────────────────────────────


class ParsedCall(BaseModel):
    function_name: str
    parameters: dict[str, Any]
    original_string: str

    def to_function_tool_call(self, tools: list[FunctionTool] | None = None) -> FunctionToolCall:
        """Validate against the declared schema and build the protocol call."""
        positional = {k for k in self.parameters if _POSITIONAL_RE.match(k)}
        if positional:
            logger.warning("Dropping positional args for '%s': %s", self.function_name, positional)
        args = {k: v for k, v in self.parameters.items() if not _POSITIONAL_RE.match(k)}

        if tools is not None:
            tool = next((t for t in tools if t.name == self.function_name), None)
            if tool is None:
                raise ValueError(
                    f"Function '{self.function_name}' not found in available tools: "
                    f"{[t.name for t in tools]}"
                )
            schema = tool.parameters if isinstance(tool.parameters, dict) else {}
            props = schema.get("properties", {})
            required = set(schema.get("required", []))
            undeclared = {k for k in args if k not in props}
            if undeclared:
                logger.warning("Dropping undeclared params for '%s': %s", self.function_name, undeclared)
                args = {k: v for k, v in args.items() if k in props}
            missing = required - set(args)
            if missing:
                raise ValueError(f"Missing required parameters for '{self.function_name}': {missing}")

        return FunctionToolCall(
            name=self.function_name,
            arguments=json.dumps(args),
            call_id=generate_id("call"),
            id=generate_id("fc"),
            status="in_progress",
        )


def _dotted_name(node: ast.expr) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    raise ValueError(f"Unsupported function target: {ast.dump(node)}")


def _literal(node: ast.AST) -> Any:
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_literal(e) for e in node.elts]
    if isinstance(node, ast.Dict):
        return {_literal(k): _literal(v) for k, v in zip(node.keys, node.values) if k is not None}
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        val = _literal(node.operand)
        if not isinstance(val, (int, float)):
            raise ValueError(f"Unsupported unary literal: {ast.dump(node)}")
        return -val if isinstance(node.op, ast.USub) else val
    raise ValueError(f"Unsupported literal: {ast.dump(node)}")


def _parse_call(expr: str) -> ParsedCall:
    parsed = ast.parse(expr, mode="eval").body
    if not isinstance(parsed, ast.Call):
        raise ValueError(f"Expression is not a function call: {expr!r}")
    params: "OrderedDict[str, Any]" = OrderedDict()
    for idx, arg in enumerate(parsed.args):
        params[f"__arg_{idx}__"] = _literal(arg)
    for kw in parsed.keywords:
        if kw.arg is None:
            raise ValueError("**kwargs are not supported")
        params[kw.arg] = _literal(kw.value)
    return ParsedCall(function_name=_dotted_name(parsed.func), parameters=params, original_string=expr)


def _split_calls_tokenized(source: str) -> list[str]:
    """Split into top-level ``name(...)`` spans via the tokenizer (handles
    nested parens and strings containing ')')."""
    tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    calls: list[str] = []
    i = 0
    while i < len(tokens):
        if tokens[i].type != tokenize.NAME:
            i += 1
            continue
        start, j = i, i + 1
        while j + 1 < len(tokens) and tokens[j].string == "." and tokens[j + 1].type == tokenize.NAME:
            j += 2
        if j >= len(tokens) or tokens[j].string != "(":
            i += 1
            continue
        depth, end, k = 0, None, j
        while k < len(tokens):
            t = tokens[k]
            if t.type == tokenize.OP and t.string == "(":
                depth += 1
            elif t.type == tokenize.OP and t.string == ")":
                depth -= 1
                if depth == 0:
                    end = k
                    break
            k += 1
        if end is None:
            i += 1
            continue
        calls.append(tokenize.untokenize(tokens[start : end + 1]).strip())
        i = end + 1
    return calls


def parse_function_call(text: str, pattern_to_match: list[str] | None = None) -> list[ParsedCall]:
    """Parse all function calls in *text* (regex fallback for malformed input)."""
    text = text.strip()
    if not text:
        return []
    pattern_to_match = pattern_to_match or []
    try:
        exprs = _split_calls_tokenized(text)
        skip_invalid = False
    except tokenize.TokenError:
        exprs = [m.group(0).strip() for m in _LENIENT_CALL_RE.finditer(text)]
        skip_invalid = True
    results: list[ParsedCall] = []
    for expr in exprs:
        try:
            call = _parse_call(expr)
        except Exception:
            if skip_invalid:
                continue
            raise
        if pattern_to_match and all(p not in call.function_name for p in pattern_to_match):
            continue
        results.append(call)
    return results


def extract_function_calls_from_text(text: str, block_regex: str = ".*") -> tuple[str, list[ParsedCall]]:
    """Find delimited blocks, parse calls inside, return (stripped_text, calls)."""
    if not block_regex:
        return text, []
    matches = list(re.finditer(block_regex, text, flags=re.DOTALL))
    if not matches:
        return text, []
    outside = re.sub(block_regex, "", text, flags=re.DOTALL)
    inside = " ".join(m.group(0) for m in matches).strip()
    if not inside:
        return outside, []
    try:
        return outside, parse_function_call(inside)
    except Exception:
        return outside, []
